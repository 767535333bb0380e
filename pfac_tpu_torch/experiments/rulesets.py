"""The rulesets and corpora the port is driven and measured with, made from
a seed with numpy.

* :func:`snort_like_patterns`: 2,000 patterns with the Snort V2.8
  statistics of the PFAC paper (lengths 1-243 skewed short, mixed
  text/binary bytes); the same generator as the repo's ``bench.py``, so
  both packages are measured on the same ruleset.
* :func:`clamav_like_patterns`: 100,000 ClamAV-scale signatures, the big
  ruleset of ``tools_bench_matrix.py`` (lengths ``gamma(3, 18) + 8``
  clipped to 8-200, uniform random bytes).
* :func:`planted_text`: printable text with a share of planted pattern
  copies (the DEFCON-like and big-ruleset corpora).
* :func:`pattern_stream`: patterns drawn at random and concatenated, the
  virus-dense worst case of ``tools_bench_matrix.py``.
* :func:`mixed_density`: ``tests/test_pallas_sieve.py``'s mixed-density
  recipe at full block size.
* :func:`f1_regime`: ROADMAP.md's F1 regime: tens of thousands of short
  random patterns, whose walk tables' entry tables alone outgrow the
  shared memory K2 and K3 have for tables.
"""
from __future__ import annotations

import numpy as np


def snort_like_patterns(seed: int = 42, k: int = 2000) -> list[bytes]:
    """Synthetic rule set with Snort-paper statistics: k patterns, lengths
    1..243 skewed short (avg ~21), mixed text/binary bytes; deduplicated
    in order."""
    rng = np.random.default_rng(seed)
    pats = []
    for _ in range(k):
        ln = int(np.clip(rng.gamma(shape=2.2, scale=9.0) + 1, 1, 243))
        if rng.random() < 0.7:  # text-ish
            p = rng.integers(32, 127, size=ln, dtype=np.int64)
        else:  # binary
            p = rng.integers(0, 256, size=ln, dtype=np.int64)
        pats.append(bytes(p.astype(np.uint8)))
    return list(dict.fromkeys(pats))


def clamav_like_patterns(rng, k: int = 100_000) -> list[bytes]:
    """The big ruleset: lengths gamma(3, 18) + 8 clipped to 8-200, uniform
    random bytes, deduplicated."""
    lens = np.clip(rng.gamma(3.0, 18.0, size=k) + 8, 8, 200).astype(int)
    raw = rng.integers(0, 256, size=int(lens.sum()), dtype=np.uint8)
    ends = np.cumsum(lens)
    return list(dict.fromkeys(raw[e - ln:e].tobytes()
                              for e, ln in zip(ends, lens)))


def planted_text(rng, pats, n: int, share: float) -> np.ndarray:
    """Printable text with `share` of its bytes planted pattern copies."""
    buf = bytearray(rng.integers(32, 127, size=n, dtype=np.uint8).tobytes())
    placed, budget = 0, int(n * share)
    while placed < budget:
        p = pats[int(rng.integers(0, len(pats)))]
        off = int(rng.integers(0, n - len(p)))
        buf[off:off + len(p)] = p
        placed += len(p)
    return np.frombuffer(buf, dtype=np.uint8)


def pattern_stream(rng, pats, n: int) -> np.ndarray:
    """`n` bytes of patterns drawn at random and concatenated (the last
    one cut)."""
    chunks, size = [], 0
    while size < n:
        p = pats[int(rng.integers(0, len(pats)))]
        chunks.append(p)
        size += len(p)
    return np.frombuffer(bytearray(b"".join(chunks)[:n]), dtype=np.uint8)


def mixed_density(rng, pats, n: int, block: int) -> np.ndarray:
    """Random bytes, every 16th block all 'z' (dense for b"zzzz"), a
    pattern planted every 177 bytes."""
    d = rng.integers(0, 256, size=n, dtype=np.uint8)
    for b0 in range(block, n, 16 * block):
        d[b0:b0 + block] = ord("z")
    for i in range(0, n - 250, 177):
        p = pats[int(rng.integers(0, len(pats)))]
        d[i:i + len(p)] = np.frombuffer(p, np.uint8)
    return d


def f1_regime(seed: int, k: int, n: int) -> tuple[list[bytes], np.ndarray]:
    """`k` distinct patterns of 3-8 random bytes (lengths uniform) and `n`
    random bytes with one of them planted every 97 bytes -> (patterns,
    corpus)."""
    rng = np.random.default_rng(seed)
    pats: dict[bytes, None] = {}
    while len(pats) < k:
        for ln in rng.integers(3, 9, size=k - len(pats)):
            pats[rng.integers(0, 256, size=int(ln), dtype=np.uint8).tobytes()] = None
    plist = list(pats)
    d = rng.integers(0, 256, size=n, dtype=np.uint8)
    for i, j in zip(range(0, n - 8, 97),
                    rng.integers(0, len(plist), size=(n - 8 + 96) // 97)):
        p = plist[int(j)]
        d[i:i + len(p)] = np.frombuffer(p, np.uint8)
    return plist, d

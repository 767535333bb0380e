"""Regime matrix of the port: one JSON line a corpus regime; counterpart of
the repo's ``tools_bench_matrix.py``.

The seven regimes, in the reference's order and drawn from one
``default_rng(42)`` stream, so that every corpus is byte-identical to the
reference's (:func:`corpora`):

* ``dense_random``: 128 MB of random bytes;
* ``defcon_like_1.5pct``: 128 MB of printable text, 1.5% of it planted
  Snort-like patterns;
* ``virus_dense_worst``: 8 MB of Snort-like patterns concatenated;
* ``reduce_device_3pct``: the device reduce alone on 64 Mi int32 match
  IDs, 3% of them 7 (``bytes`` counts positions, as in the reference);
* ``big_ruleset_100k_defcon``: 100,000 ClamAV-scale signatures
  (``rulesets.clamav_like_patterns``, the CSR tier) over 64 MB of text,
  0.2% planted;
* ``benchmark1_all_match`` / ``benchmark1_no_match``: ``aaaa`` over 100 MB
  of ``a`` / ``b`` (the PFAC hash paper's Benchmark I).

The first three run on 2,000 Snort-like patterns
(``rulesets.snort_like_patterns``, ``bench.py``'s generator).

Each line: ``regime``, ``bytes``, ``ms`` (the e2e median, host included),
``GBps``, ``device`` (the card's name), ``power_limit`` (as nvidia-smi
prints it), ``spread``; on the matcher's regimes also ``survivors`` (the
compaction's count on the device, read once outside the timed window),
``kernel_ms`` (K1 alone, ``backends/sieve.sieve``) with its
``kernel_spread``, and ``walker_ms`` = ``ms`` - ``kernel_ms``;
``slice_matches_per_MB`` on the DEFCON-like corpus, ``matches`` on the
reduce, ``patterns``, ``alive_resid_bits`` and ``csr_hbm_mb`` (the CSR
arena and descriptor rows on the device) on the big ruleset; ``scale``
where it is not 1. The reference's ``reference_GBps`` fields are left out:
they are the CUDA library's published figures, not this card's. Timing is
``tools/bench.py``'s: CUDA-event medians of warm single calls until three
estimates lie within 10% (at most 6).

Gates, all before any timing: each matcher regime's first 1 MB (64 KB of
Benchmark I) against the golden model (``match_dense_batch``; the big
ruleset's against ``match_edges_batch``, and at full scale its CSR tier);
``virus_dense_worst``'s whole result against the plain pipeline
(``pipeline.run(..., plain=True)``) and ``match_dense_batch``; the
reduce's ``(ids, positions, count)`` against ``reduce.reduce_plain`` in
full.

Run:  python -m pfac_tpu_torch.tools.bench_matrix [--regimes a,b]
          [--out PATH] [--scale k] [--device cpu]
``--regimes`` picks regimes (the stream is drawn in full order all the
same); ``--out`` also writes the lines to PATH (nothing is written
otherwise); ``--scale k`` divides every size, ruleset included, for the
CPU tests. On the card by default; without a GPU it exits 1 unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Iterator

import numpy as np
import torch

REGIMES = ("dense_random", "defcon_like_1.5pct", "virus_dense_worst",
           "reduce_device_3pct", "big_ruleset_100k_defcon",
           "benchmark1_all_match", "benchmark1_no_match")
MB = 1 << 20
CORPUS = 128 * MB
VIRUS = 8 * MB
REDUCE = 64 * MB           # positions
BIG = 64 * MB
BIG_K = 100_000
BENCH1 = 100 * MB
SLICE = MB                 # the golden gate's bytes
BENCH1_SLICE = 1 << 16
TRIES = 6
_DRAW = 1 << 22


@dataclasses.dataclass
class Regime:
    """One regime's input: a uint8 corpus and its ruleset, or (the reduce)
    an int32 match vector and no ruleset."""

    name: str
    host: np.ndarray
    patterns: list[bytes] | None


def reduce_vector(rng, n: int) -> np.ndarray:
    """int32[n]: 7 where a draw from 0-99 is below 3, else 0; drawn in
    pieces, the same stream as one draw of n."""
    out = np.empty(n, dtype=np.int32)
    for c0 in range(0, n, _DRAW):
        c1 = min(n, c0 + _DRAW)
        out[c0:c1] = np.where(rng.integers(0, 100, size=c1 - c0) < 3, 7, 0)
    return out


def corpora(scale: int = 1, seed: int = 42) -> Iterator[Regime]:
    """The regimes in order, each drawn from one ``default_rng(seed)``
    stream when the iterator reaches it; sizes divided by `scale`."""
    from ..experiments import rulesets

    snort = rulesets.snort_like_patterns()
    rng = np.random.default_rng(seed)
    n = CORPUS // scale
    yield Regime("dense_random",
                 rng.integers(0, 256, size=n, dtype=np.uint8), snort)
    yield Regime("defcon_like_1.5pct",
                 rulesets.planted_text(rng, snort, n, 0.015), snort)
    yield Regime("virus_dense_worst",
                 rulesets.pattern_stream(rng, snort, VIRUS // scale), snort)
    yield Regime("reduce_device_3pct", reduce_vector(rng, REDUCE // scale),
                 None)
    big = rulesets.clamav_like_patterns(rng, BIG_K // scale)
    yield Regime("big_ruleset_100k_defcon",
                 rulesets.planted_text(rng, big, BIG // scale, 0.002), big)
    aaaa = [b"aaaa"]
    for name, ch in (("benchmark1_all_match", "a"),
                     ("benchmark1_no_match", "b")):
        yield Regime(name, np.full(BENCH1 // scale, ord(ch), np.uint8), aaaa)


@dataclasses.dataclass
class Run:
    """A regime made ready on a device: its corpus there and its engine
    (a ``SieveMatcher``; None for the reduce)."""

    regime: Regime
    data: torch.Tensor
    engine: object | None
    scale: int
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.regime.name


def prepare(device, names=REGIMES, scale: int = 1) -> list[Run]:
    """The regimes `names` on `device`, in the reference's order; one
    engine a ruleset."""
    from ..core.automaton import Automaton
    from ..backends.sieve_matcher import SieveMatcher

    dev = torch.device(device)
    engines: dict[int, SieveMatcher] = {}
    runs = []
    last = max(REGIMES.index(nm) for nm in names)
    for reg in corpora(scale):
        if reg.name in names:
            eng = None
            if reg.patterns is not None:
                key = id(reg.patterns)
                if key not in engines:
                    engines[key] = SieveMatcher(
                        Automaton.from_patterns(reg.patterns), device=dev)
                eng = engines[key]
            runs.append(Run(reg, torch.from_numpy(reg.host).to(dev), eng,
                            scale))
        if REGIMES.index(reg.name) == last:
            break
    return runs


def survivors(run: Run) -> int:
    """The compaction's survivor count on the run's corpus (K1 and the
    compaction as the pipeline launches them), read back once."""
    from ..backends import compact, pipeline, sieve
    from ..backends.sieve_matcher import npad_for

    eng, n = run.engine, run.data.shape[0]
    block = eng.tile_rows * 128
    _, bits, counts = sieve.sieve(run.data, n, npad_for(n, eng.tile_rows),
                                  eng._sieve, block)
    return int(compact.compact(bits, counts,
                               pipeline.threshold(eng._walk, block))[1])


def check(run: Run) -> None:
    """The regime's gates; a failed one raises AssertionError."""
    from ..backends import golden, pipeline, reduce
    from ..backends.sieve_matcher import npad_for

    host, eng = run.regime.host, run.engine
    if eng is None:
        got = reduce.reduce_from_dense(run.data)
        want = reduce.reduce_plain(run.data)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), \
            f"{run.name}: the reduce != reduce_plain"
        assert int(got[2]) == int((host > 0).sum())
        run.extra["matches"] = int(got[2])
        return
    a = eng.automaton
    s = host[:BENCH1_SLICE if run.name.startswith("benchmark1") else SLICE]
    if run.name.startswith("big_ruleset"):
        if run.scale == 1:
            assert eng.walk_tables is None and eng.csr_tables is not None, \
                "expected the CSR tier for the 100K ruleset"
        want = golden.match_edges_batch(a, s)
    else:
        want = golden.match_dense_batch(a, s)
    assert np.array_equal(eng.match(s), want), f"{run.name}: parity failed"
    if run.name.startswith("defcon_like"):
        run.extra["slice_matches_per_MB"] = int((want > 0).sum())
    if run.name == "virus_dense_worst":
        n = host.shape[0]
        npad = npad_for(n, eng.tile_rows)
        res = eng.match_device(run.data)
        plain = pipeline.run(run.data, n, npad, eng._sieve, eng._walk,
                             eng._csr, block=eng.tile_rows * 128, plain=True)
        assert torch.equal(res, plain), f"{run.name}: != the plain pipeline"
        assert np.array_equal(res[:n].cpu().numpy(),
                              golden.match_dense_batch(a, host)), \
            f"{run.name}: != match_dense_batch"


def measure(run: Run, card: tuple[str, str | None]) -> dict:
    """Time the regime -> its JSON record."""
    from ..backends import reduce, sieve
    from ..backends.sieve_matcher import npad_for
    from .bench import estimate

    dev, eng, d = run.data.device, run.engine, run.data
    n = d.shape[0]
    if eng is None:
        fn = lambda: reduce.reduce_from_dense(d)
    else:
        fn = lambda: eng.match_device(d)
    ms, spread, _ = estimate(fn, dev, TRIES)
    rec = {"regime": run.name, "bytes": n, "ms": ms, "GBps": n / ms / 1e6,
           "device": card[0], "power_limit": card[1], "spread": spread}
    if eng is not None:
        npad = npad_for(n, eng.tile_rows)
        kms, kspread, _ = estimate(lambda: sieve.sieve(
            d, n, npad, eng._sieve, eng.tile_rows * 128), dev, TRIES)
        rec.update(survivors=survivors(run), kernel_ms=kms,
                   kernel_spread=kspread, walker_ms=ms - kms)
    if run.name.startswith("big_ruleset"):
        csr = eng._csr
        rec.update(patterns=len(run.regime.patterns),
                   alive_resid_bits=(None if eng.tables.alive is None
                                     else 16),
                   csr_hbm_mb=(None if csr is None else 4 * (
                       csr.arena.numel() + csr.desc.numel()) / 1e6))
    rec.update(run.extra)
    if run.scale != 1:
        rec["scale"] = run.scale
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--regimes", default=",".join(REGIMES),
                    help="comma-separated regimes (default: all seven)")
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    ap.add_argument("--scale", type=int, default=1,
                    help="divide every size by this (the CPU tests)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    names = [x for x in args.regimes.split(",") if x]
    bad = [x for x in names if x not in REGIMES]
    if bad or not names:
        ap.error(f"unknown regimes {bad}; choose from {', '.join(REGIMES)}")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench_matrix: no GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from .bench import card_of

    card = card_of(dev)
    runs = prepare(dev, names, args.scale)
    for r in runs:
        check(r)
    lines = []
    for r in runs:
        lines.append(json.dumps(measure(r, card)))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(line + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())

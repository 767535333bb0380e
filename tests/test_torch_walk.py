"""Plain K2 (the port's survivor walk on a CPU tensor) against the
reference's Pallas walker in interpret mode and its host oracle, bit-exact
(tolerance 0).

The reference walker runs as ``build_walker(..., interpret=True)`` without
the sieve tables, so it reports matches of >= 4 bytes only; the port's walk
writes exactly those into a zeroed result.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfac_tpu.backends import pallas_walk as W
from pfac_tpu_torch.backends import walk
from pfac_tpu_torch.backends.walk_tables import build_walk_tables, walk_oracle
from pfac_tpu_torch.core import Automaton


def _compare(pats, data: bytes, positions=None, n=None):
    a = Automaton.from_patterns(pats)
    n = len(data) if n is None else n
    if positions is None:
        positions = list(range(n))
    jt = W.build_walk_tables(a)
    cap = -(-max(1, len(positions)) // W.GROUP) * W.GROUP
    pos = np.full(cap, len(data) + 64, np.int32)      # padding: past n
    pos[:len(positions)] = positions
    pad = np.zeros(max(1, -(-len(data) // 128)) * 128, np.uint8)
    pad[:len(data)] = np.frombuffer(data, np.uint8)
    run = W.build_walker(jt, cap=cap, interpret=True)
    ref = np.asarray(run([jnp.asarray(x) for x in jt.arrays],
                         jnp.asarray(pad.reshape(-1, 128)), jnp.asarray(pos),
                         jnp.full((1,), n, jnp.int32)))[:len(positions)]

    wt = build_walk_tables(a)
    out = torch.zeros(len(data), dtype=torch.int32)
    walk.walk(torch.from_numpy(np.frombuffer(data, np.uint8).copy()), n,
              torch.tensor(positions, dtype=torch.int32), out,
              wt.to_device("cpu"))
    got = out.numpy()[positions]
    oracle = [walk_oracle(wt, data, p, n) for p in positions]
    jax_oracle = [W.walk_oracle(jt, data, p, n) for p in positions]
    assert got.tolist() == ref.tolist()
    assert oracle == jax_oracle == ref.tolist()
    untouched = np.setdiff1d(np.arange(len(data)), positions)
    assert not out.numpy()[untouched].any()
    return got


def test_odd_and_even_lengths():
    got = _compare([b"abcd", b"abcde", b"abcdef", b"abcdefgh", b"zzzz",
                    b"qwertyz"],
                   b"xxabcdefghyyzzzzabcdeQqwertyzabcdefXabcdefg" + bytes(9))
    assert got.any()


def test_big_endian_keys_high_bytes():
    # entry keys are big-endian; bytes >= 0x80 make the int32 key words
    # negative in the reference tables
    pats = [bytes([0xFF, 0x80, 0x81, 0xFE]), bytes([0x80, 0, 0, 0, 0xC3]),
            bytes([0x90, 0x91, 0x92, 0x93, 0x94, 0x95]), b"\x00\x00\x00\x00"]
    data = b"".join(pats) + bytes([0xFF, 0x80, 0x81]) + bytes(8)
    got = _compare(pats, data)
    assert got.any()


def test_maxd_at_corpus_end():
    # n cuts the patterns: only the windows that fit before n may match
    data = b"...." + b"abcdefgh"
    for n in (8, 9, 10, 11, 12):
        _compare([b"abcdefgh", b"abcdef", b"abcde", b"abcd"], data,
                 positions=list(range(n)), n=n)


def test_row_straddle_survivors():
    pat = b"HELLOWORLD!!"
    data = bytearray(400)
    for off in (0, 1, 3, 60, 61, 63, 64, 65, 127, 128, 200, 255, 256, 387):
        data[off:off + len(pat)] = pat
    _compare([pat, b"HELL", b"HELLOW"], bytes(data))


def test_duplicates_later_id_wins():
    got = _compare([b"wxyz!", b"wxyz!", b"wxyz"], b"wxyz!wxyz")
    assert got[0] == 2 and got[5] == 3


@pytest.mark.parametrize("seed", range(3))
def test_random(seed):
    rng = np.random.default_rng(100 + seed)
    alpha = rng.integers(0, 256, size=3).astype(np.uint8)
    pats = [bytes(alpha[rng.integers(0, 3, size=int(rng.integers(1, 14)))])
            for _ in range(int(rng.integers(2, 20)))]
    pats.append(bytes(alpha[rng.integers(0, 3, size=7)]))
    data = bytes(alpha[rng.integers(0, 3, size=300)])
    _compare(pats, data)


@pytest.mark.parametrize("count", [0, 1, 5, 9, 40])
def test_positions_past_the_count_are_not_walked(count):
    # the pipeline's contract: `pos` is a buffer longer than the survivors,
    # their number a 1-element tensor; the buffer's words past the count are
    # positions < n that would match, and must not be walked. A count past
    # the buffer walks all of it.
    pats = [b"abcd", b"abcdef", b"zzzz", b"zzzzzz"]
    data = b"xabcdefzzzzzzabcd" * 3
    n = len(data)
    wt = build_walk_tables(Automaton.from_patterns(pats)).to_device("cpu")
    t = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    starts = [p for p in range(n)
              if walk_oracle(build_walk_tables(Automaton.from_patterns(pats)),
                             data, p, n)]
    rng = np.random.default_rng(count)
    pos = torch.tensor(rng.permutation(starts), dtype=torch.int32)
    assert pos.numel() == 15
    out = torch.zeros(n, dtype=torch.int32)
    walk.walk(t, n, pos, out, wt, torch.tensor([count], dtype=torch.int32))
    want = torch.zeros(n, dtype=torch.int32)
    walk.walk_plain(t, n, pos[:count].clone(), want, wt)
    assert torch.equal(out, want)
    assert int((out > 0).sum()) == min(count, pos.numel())
    with pytest.raises(ValueError, match="count"):
        walk.walk(t, n, pos, out, wt, torch.tensor([count]))   # int64

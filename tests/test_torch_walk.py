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


# "abcdefghi" makes three steps: depth 4 -> 6 and 6 -> 8 by main tables,
# then at depth 8 an odd table (the 9-byte pattern) and no main table
STEP_PATS = [b"abcdefghi", b"abcd", b"qwer"]
STEP_DATA = b"xxxxabcdzzabcdefghi..qwerabcdefghi"


@pytest.mark.parametrize("at,cut,want", [
    (0, 0, 1),      # "xxxx": no entry state, the entry probe alone
    (4, 0, 2),      # "abcdzz": entry, then step 0 finds no state (DEAD)
    (21, 0, 2),     # "qwer" + "ab": a pattern's leaf, DEAD after step 0
    (10, 0, 4),     # the whole 9-byte pattern: entry, steps 0 and 1, and
                    # step 2, which has no main table, ends it
    (25, 3, 3),     # n cuts the last copy to 6 bytes: step 1 needs 8
    (25, 4, 2),     # ... to 5 bytes: step 0 needs 6
])
def test_walk_steps_plain_hand_worked(at, cut, want):
    wt = build_walk_tables(Automaton.from_patterns(STEP_PATS)).to_device(
        "cpu")
    assert walk.steps_of(wt) == 3
    rows = [r[6] for r in wt.rows[2:]]          # present: main, odd, even
    assert rows == [1, 0, 0, 1, 0, 0, 0, 1, 0]
    data = torch.frombuffer(bytearray(STEP_DATA), dtype=torch.uint8)
    n = len(STEP_DATA) - cut
    pos = torch.tensor([at], dtype=torch.int32)
    assert walk.walk_steps_each_plain(data, n, pos, wt).tolist() == [want]
    assert walk.walk_steps_plain(data, n, pos, wt) == want


def test_walk_steps_plain_sums_the_counted_positions():
    wt = build_walk_tables(Automaton.from_patterns(STEP_PATS)).to_device(
        "cpu")
    data = torch.frombuffer(bytearray(STEP_DATA), dtype=torch.uint8)
    pos = torch.tensor([0, 4, 10, 21, 25, 10], dtype=torch.int32)
    n = len(STEP_DATA)
    assert walk.walk_steps_each_plain(data, n, pos, wt).tolist() == [
        1, 2, 4, 2, 4, 4]
    assert walk.walk_steps_plain(data, n, pos, wt,
                                 torch.tensor([3], dtype=torch.int32)) == 7
    assert walk.walk_steps_plain(data, n, pos[:0], wt) == 0


def test_matcher_on_a_pattern_stream_equals_golden():
    # the virus-dense worst case at a small size: the Snort-like set's
    # patterns concatenated; K1 lets a few percent of the positions
    # through, and the walk takes them several steps deep
    import pfac_tpu_torch as pt
    from pfac_tpu_torch.backends import golden, sieve
    from pfac_tpu_torch.backends.sieve_matcher import npad_for
    from pfac_tpu_torch.experiments import rulesets

    pats = rulesets.snort_like_patterns()
    host = rulesets.pattern_stream(np.random.default_rng(20), pats, 1 << 16)
    m = pt.Matcher(pats, device="cpu")
    data = torch.from_numpy(host.copy())
    got = m.match_device(data)
    n = host.shape[0]
    assert got.numpy()[:n].tolist() == golden.match_dense_batch(
        m.automaton, host).tolist()
    assert not got[n:].any()
    eng = m._engine()
    _, bits, counts = sieve.sieve_plain(data, n, npad_for(n), eng._sieve)
    pos = torch.nonzero(sieve.unpack_bits(bits)[:n]).flatten().to(
        torch.int32)
    assert 0.02 < pos.numel() / n < 0.08, pos.numel()
    steps = walk.walk_steps_plain(data, n, pos, eng._walk)
    assert 1.5 < steps / pos.numel() < 20, steps / pos.numel()

"""Plain K2 (the port's survivor walk on a CPU tensor) against the
reference's Pallas walker in interpret mode and its host oracle, bit-exact
(tolerance 0).

The reference walker runs as ``build_walker(..., interpret=True)`` without
the sieve tables, so it reports matches of >= 4 bytes only; the port's walk
writes exactly those into a zeroed result.

K2's image of the tables (``walk.image``: values in 16 bits) holds the
arena's tables word for word, refuses a value of 2^16 or more, fits the
Snort-like set whole in K2's shared memory, keeps a longer prefix than the
arena for sets that do not fit, and, walked on the host as the kernel reads
it (``walk.image_walk_plain``), equals ``walk_plain``.
"""
import bisect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pfac_tpu_torch as pt
from pfac_tpu.backends import pallas_walk as W
from pfac_tpu_torch.backends import sieve, walk
from pfac_tpu_torch.backends.probe import Packed, desc_array
from pfac_tpu_torch.backends.sieve_matcher import npad_for
from pfac_tpu_torch.backends.walk_tables import build_walk_tables, walk_oracle
from pfac_tpu_torch.core import Automaton
from pfac_tpu_torch.experiments import rulesets


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


# --------------------------------------------------------------------------
# K2's image of the tables
# --------------------------------------------------------------------------

def _f1_patterns():
    """ROADMAP.md's F1 ruleset: 17,000 random 6-byte patterns (seed
    17000), whose entry table alone outgrows the arena's shared memory."""
    rng = np.random.default_rng(17000)
    return [bytes(rng.integers(0, 256, size=6, dtype=np.uint8))
            for _ in range(17000)]


IMAGE_SETS = {
    "snort": rulesets.snort_like_patterns,
    "f1": _f1_patterns,
    "steps": lambda: STEP_PATS,
    "snort_3000": lambda: rulesets.snort_like_patterns(seed=7, k=3000),
}


@pytest.fixture(scope="module")
def walk_sets():
    return {}


def _tabs(walk_sets, name) -> Packed:
    if name not in walk_sets:
        walk_sets[name] = pt.Matcher(IMAGE_SETS[name](),
                                     device="cpu")._engine()
    return walk_sets[name]._walk


CARD = torch.device("cuda", 0)       # K2's plan reads the device's index only


def _budget(tabs: Packed) -> int:
    return sieve.SMEM_LIMIT - walk.fixed_smem_bytes(walk.steps_of(tabs))


@pytest.mark.parametrize("name", ["snort", "f1", "steps"])
def test_image_holds_the_arenas_tables(walk_sets, name):
    # the same rows in the same order: displacements and keys word for
    # word, values as half-words equal to the arena's words, every array
    # on 16 bytes, each table ending where the image's table ends say
    tabs = _tabs(walk_sets, name)
    img = walk.image(tabs)
    assert walk.image(tabs) is img                # built once, kept
    a = tabs.arena.numpy()
    w = img.arena.numpy()
    h = w.view(np.uint16)
    assert len(img.rows) == len(tabs.rows)
    assert np.array_equal(img.desc.numpy(), desc_array(img.rows))
    want_bytes, ends = 0, []
    for r, q in zip(tabs.rows, img.rows):
        if not r[6]:
            assert q == (0, 0, 0, -1, -1, -1, 0, 0)
            continue
        assert q[:3] == r[:3] and q[6:] == r[6:]
        slots = 1 << r[2]
        if r[3] < 0:
            assert q[3] == -1
        else:
            nb = 1 << r[1]
            assert q[3] % 4 == 0
            assert np.array_equal(w[q[3]:q[3] + nb], a[r[3]:r[3] + nb])
            want_bytes += -(-4 * nb // 16) * 16
        assert q[4] % 4 == 0 and q[5] % 8 == 0
        assert np.array_equal(w[q[4]:q[4] + slots], a[r[4]:r[4] + slots])
        assert np.array_equal(h[q[5]:q[5] + slots].astype(np.int64),
                              a[r[5]:r[5] + slots].astype(np.int64))
        want_bytes += 4 * slots + -(-2 * slots // 16) * 16
        ends.append(-(-(q[5] + slots) // 8) * 4)
    assert walk.table_ends(img) == ends
    assert ends[-1] == w.size and 4 * w.size == want_bytes


def test_image_refuses_a_value_past_16_bits():
    tabs = build_walk_tables(Automaton.from_patterns(STEP_PATS)).to_device(
        "cpu")
    row = tabs.rows[2]                            # step 0's main table
    for value, ok in ((0xFFFF, True), (1 << 16, False), (-1, False)):
        arena = tabs.arena.clone()
        arena[row[5] + 1] = value
        img_of = lambda: walk.image(Packed(arena=arena, desc=tabs.desc,
                                           rows=tabs.rows))
        if ok:
            img = img_of()
            h = img.arena.numpy().view(np.uint16)
            assert int(h[img.rows[2][5] + 1]) == value
        else:
            with pytest.raises(ValueError, match="16-bit"):
                img_of()


def test_snort_image_is_whole_in_shared_memory(walk_sets):
    # the arena's 260,832 B outgrew K2's budget beside its descriptor
    # rows, and the tables of depth >= 32 were read through L1/L2; the
    # image's 199,856 B fit whole
    tabs = _tabs(walk_sets, "snort")
    img = walk.image(tabs)
    nsteps = walk.steps_of(tabs)
    assert 4 * tabs.arena.numel() == 260_832
    assert 4 * img.arena.numel() == 199_856
    assert _budget(tabs) == 227_792
    assert walk.launch_plan(tabs, CARD) == (nsteps, img.arena.numel())
    assert walk.fixed_smem_bytes(nsteps) + 199_856 <= sieve.SMEM_LIMIT
    old = walk.resident_words(tabs, _budget(tabs))
    assert old == 56_776 and walk.table_ends(tabs).index(old) + 1 == 44


@pytest.mark.parametrize("name", ["f1", "snort_3000"])
def test_overflowing_image_keeps_a_longer_prefix(walk_sets, name):
    # where the image does not fit whole, K2 keeps at least as many whole
    # tables as the arena's prefix would have held, within its budget
    tabs = _tabs(walk_sets, name)
    img = walk.image(tabs)
    budget = _budget(tabs)
    resident = walk.launch_plan(tabs, CARD)[1]
    assert 0 < resident < img.arena.numel() and 4 * resident <= budget
    tables = bisect.bisect_right(walk.table_ends(img), resident)
    old = bisect.bisect_right(walk.table_ends(tabs),
                              walk.resident_words(tabs, budget))
    assert tables >= old
    if name == "snort_3000":
        assert old > 0 and tables > old


@pytest.mark.parametrize("corpus", ["pattern_stream", "planted_text"])
def test_image_walk_equals_walk_plain(walk_sets, corpus):
    # 1 MiB of the Snort-like set's own patterns concatenated (the
    # virus-dense worst case) and of text with 1.5% planted copies: K1's
    # survivors walked over the image as the kernel reads it equal the
    # arena's plain walk, and so do a count's first positions
    tabs = _tabs(walk_sets, "snort")
    pats = IMAGE_SETS["snort"]()
    rng = np.random.default_rng(21)
    n = 1 << 20
    host = (rulesets.pattern_stream(rng, pats, n) if corpus == "pattern_stream"
            else rulesets.planted_text(rng, pats, n, 0.015))
    data = torch.from_numpy(host.copy())
    eng = walk_sets["snort"]
    _, bits, _ = sieve.sieve_plain(data, n, npad_for(n), eng._sieve)
    pos = torch.nonzero(sieve.unpack_bits(bits)[:n]).flatten().to(
        torch.int32)
    assert pos.numel() > 500
    img = walk.image(tabs)
    for count in (None, torch.tensor([pos.numel() // 3], dtype=torch.int32)):
        want = torch.zeros(n, dtype=torch.int32)
        got = torch.zeros(n, dtype=torch.int32)
        walk.walk_plain(data, n, pos, want, tabs, count)
        walk.image_walk_plain(data, n, pos, got, img, count)
        assert torch.equal(got, want) and int((want > 0).sum()) > 100

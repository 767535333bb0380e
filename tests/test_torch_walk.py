"""Plain K2 (the port's survivor walk on a CPU tensor) against the
reference's Pallas walker in interpret mode and its host oracle, bit-exact
(tolerance 0).

The reference walker runs as ``build_walker(..., interpret=True)`` without
the sieve tables, so it reports matches of >= 4 bytes only; the port's walk
writes exactly those into a zeroed result.

The walk tables' one device layout (``walk_tables.pack_walk``: values in
16-bit half-words, read by K2, K3 and the plain walkers) holds the host
tables word for word, refuses a value of 2^16 or more, fits the Snort-like
set whole in K2's shared memory, gives K2 and K3 at least as many whole
tables in shared memory as 32-bit values would (sizes computed from the
host tables), and, walked on the host as the kernels read it
(``walk.walk_plain``), gives the golden model's matches of >= 4 bytes.
"""
import bisect
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pfac_tpu_torch as pt
from pfac_tpu.backends import pallas_walk as W
from pfac_tpu_torch.backends import block_walk, golden, sieve, walk
from pfac_tpu_torch.backends.probe import Packed, desc_array
from pfac_tpu_torch.backends.sieve_matcher import npad_for
from pfac_tpu_torch.backends.walk_tables import (DISP_BIT, PRESENT_BIT,
                                                 build_walk_tables,
                                                 pack_walk, walk_oracle,
                                                 walk_records, wprobe)
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
# the walk tables' device layout
# --------------------------------------------------------------------------

def _f1_patterns():
    """ROADMAP.md's F1 ruleset: 17,000 random 6-byte patterns (seed
    17000), whose entry table alone outgrows K3's shared memory."""
    rng = np.random.default_rng(17000)
    return [bytes(rng.integers(0, 256, size=6, dtype=np.uint8))
            for _ in range(17000)]


def _small_patterns():
    """40 random patterns of 4-12 bytes: every walk table holds at most 64
    keys, so every one is displacement-free."""
    rng = np.random.default_rng(40)
    return [bytes(rng.integers(0, 256, size=int(rng.integers(4, 13)),
                               dtype=np.uint8)) for _ in range(40)]


IMAGE_SETS = {
    "snort": rulesets.snort_like_patterns,
    "f1": _f1_patterns,
    "steps": lambda: STEP_PATS,
    "snort_3000": lambda: rulesets.snort_like_patterns(seed=7, k=3000),
    "aaaa": lambda: [b"aaaa"],
    "nodisp": _small_patterns,
    # step 0 has neither an odd nor an even table; its last step has a main
    "no_odd_even": lambda: [b"abcdefgh", b"abcdwxyz", b"qwer"],
}


@pytest.fixture(scope="module")
def walk_sets():
    return {}


def _engine(walk_sets, name):
    if name not in walk_sets:
        walk_sets[name] = pt.Matcher(IMAGE_SETS[name](),
                                     device="cpu")._engine()
    return walk_sets[name]


def _tabs(walk_sets, name) -> Packed:
    return _engine(walk_sets, name)._walk


def _probes(wt) -> list:
    """The host tables in descriptor-row order (WalkTables.to_device)."""
    out = [wt.entry, wt.entry_final]
    for s in wt.steps:
        out += [s.main, s.odd, s.even]
    return out


def _wide_ends(wt) -> list[int]:
    """Words at which each table would end with 32-bit values and no
    padding (the layout's predecessor): from the host tables' sizes."""
    ends, off = [], 0
    for p in _probes(wt):
        if p is not None:
            off += (0 if p.disp is None else p.disp.size) + p.keys.size \
                + p.vals.size
            ends.append(off)
    return ends


CARD = torch.device("cuda", 0)       # K2's plan reads the device's index only


def _budget(tabs: Packed) -> int:
    return sieve.SMEM_LIMIT - walk.fixed_smem_bytes(walk.steps_of(tabs))


@pytest.mark.parametrize("name", ["snort", "f1", "steps"])
def test_image_holds_the_arenas_tables(walk_sets, name):
    # the host tables in row order: displacements and keys word for word,
    # values as half-words, every array on 16 bytes, each table ending
    # where the layout's table ends say
    eng = _engine(walk_sets, name)
    tabs = eng._walk
    probes = _probes(eng.walk_tables)
    w = tabs.arena.numpy()
    h = w.view(np.uint16)
    assert len(tabs.rows) == len(probes)
    assert np.array_equal(tabs.desc.numpy(), desc_array(tabs.rows))
    want_bytes, ends = 0, []
    for p, q in zip(probes, tabs.rows):
        if p is None:
            assert q == (0, 0, 0, -1, -1, -1, 0, 0)
            continue
        assert q[:3] == (p.mul, p.lg_b, p.lg_r) and q[6:] == (1, 0)
        slots = 1 << p.lg_r
        if p.disp is None:
            assert q[3] == -1
        else:
            nb = 1 << p.lg_b
            assert q[3] % 4 == 0 and p.disp.size == nb
            assert np.array_equal(w[q[3]:q[3] + nb], p.disp)
            want_bytes += -(-4 * nb // 16) * 16
        assert q[4] % 4 == 0 and q[5] % 8 == 0
        assert p.keys.size == p.vals.size == slots
        assert np.array_equal(w[q[4]:q[4] + slots], p.keys)
        assert np.array_equal(h[q[5]:q[5] + slots].astype(np.int64),
                              p.vals.astype(np.int64))
        want_bytes += 4 * slots + -(-2 * slots // 16) * 16
        ends.append(-(-(q[5] + slots) // 8) * 4)
    assert walk.table_ends(tabs) == ends
    assert ends[-1] == w.size and 4 * w.size == want_bytes


def test_image_refuses_a_value_past_16_bits():
    wt = build_walk_tables(Automaton.from_patterns(STEP_PATS))
    probes = _probes(wt)
    main = probes[2]                              # step 0's main table
    for value, ok in ((0xFFFF, True), (1 << 16, False), (-1, False)):
        vals = main.vals.copy()
        vals[1] = value
        swapped = probes[:2] + [dataclasses.replace(main, vals=vals)] \
            + probes[3:]
        if ok:
            tabs = pack_walk(swapped, "cpu")
            h = tabs.arena.numpy().view(np.uint16)
            assert int(h[tabs.rows[2][5] + 1]) == value
        else:
            with pytest.raises(ValueError, match="16-bit"):
                pack_walk(swapped, "cpu")


ABSENT = (0, 0, 0, -1, -1, -1, 0)


def _decode_records(records: torch.Tensor) -> list[list[tuple]]:
    """K2's records unpacked as csrc/walk.cu's rec_probe and present()
    unpack them: a record a loop iteration, three probes of (mul, lg_b,
    lg_r, disp_off, key_off, val_off, present); a probe without the present
    bit is absent, whatever the card reads for it."""
    words = records.numpy().view(np.uint32).reshape(-1, 3, 4)
    out = []
    for rec in words:
        probes = []
        for mul, key, val, meta in (map(int, q) for q in rec):
            if not meta & PRESENT_BIT:
                assert (mul, key, val, meta) == (0, 0, 0, 0)
                probes.append(ABSENT)
                continue
            lg_b, lg_r = meta & 31, (meta >> 8) & 31   # the shifts' bits
            disp = key - max(1 << lg_b, 4) if meta & DISP_BIT else -1
            probes.append((mul, lg_b, lg_r, disp, key, val, 1))
        out.append(probes)
    return out


@pytest.mark.parametrize("name", ["snort", "aaaa", "f1", "nodisp",
                                  "no_odd_even", "steps"])
def test_records_hold_the_rows(walk_sets, name):
    # K2's record t holds the three descriptor rows of its loop's
    # iteration t, probe for probe as the card unpacks them: the entry and
    # entry_final at t = 0 (no odd), step t - 1's main, odd and even after
    # it; a record a step and the entry's, 48 bytes each
    tabs = _tabs(walk_sets, name)
    rows = [r[:7] for r in tabs.rows]
    nsteps = walk.steps_of(tabs)
    got = _decode_records(tabs.records)
    want = [[rows[0], ABSENT, rows[1]]] + [
        rows[3 * t - 1: 3 * t + 2] for t in range(1, nsteps + 1)]
    assert got == want
    assert tabs.records.shape == (nsteps + 1, 12)
    assert torch.equal(tabs.records, torch.from_numpy(walk_records(
        tabs.rows)))
    assert walk.fixed_smem_bytes(nsteps) == 16 + 48 * (nsteps + 1)
    present = [r for r in rows if r[6]]
    disp = {r[3] >= 0 for r in present}
    steps = [rows[r:r + 3] for r in range(2, len(rows), 3)]
    if name == "aaaa":
        assert nsteps == 0 and len(got) == 1
    elif name == "nodisp":
        assert disp == {False}
    elif name == "snort":
        assert disp == {False, True}
    elif name == "f1":                  # its three tables, 17,000 keys each
        assert disp == {True} and len(present) == 3
    elif name == "no_odd_even":
        assert not steps[0][1][6] and not steps[0][2][6] and steps[-1][0][6]
    else:                               # the last step has no main table
        assert not steps[-1][0][6] and steps[-1][1][6]


@pytest.mark.parametrize("field,value", [("lg_b", 32), ("lg_r", 32),
                                         ("lg_r", -1), ("disp", None)])
def test_records_refuse_a_table_past_the_record(field, value):
    # a table whose lg_b or lg_r leaves 0..31 does not fit a record's meta
    # word, and K2 takes a displacement below the table's slots (it XORs
    # it into h1 unmasked): pack_walk refuses both, as it refuses a value
    # past 16 bits; a displacement one below the slots is taken
    probes = _probes(build_walk_tables(Automaton.from_patterns(STEP_PATS)))
    table = probes[2]
    if field == "disp":                 # a table of 100 keys has them
        table = wprobe(np.arange(100, dtype=np.uint32) * 7919 + 3,
                       np.arange(100) + 1)
        assert table.disp is not None
        disp = table.disp.copy()
        disp[0] = (1 << table.lg_r) - 1
        pack_walk(probes[:2] + [dataclasses.replace(table, disp=disp)]
                  + probes[3:], "cpu")
        disp[0] = 1 << table.lg_r
        value = disp
    swapped = probes[:2] + [dataclasses.replace(table, **{field: value})] \
        + probes[3:]
    with pytest.raises(ValueError, match="K2's record"):
        pack_walk(swapped, "cpu")


def test_snort_image_is_whole_in_shared_memory(walk_sets):
    # 32-bit values would make the tables 260,832 B, past K2's budget
    # beside its records, and leave the tables of depth >= 32 to L1/L2;
    # the layout's 199,856 B fit whole
    eng = _engine(walk_sets, "snort")
    tabs = eng._walk
    nsteps = walk.steps_of(tabs)
    wide = _wide_ends(eng.walk_tables)
    assert 4 * wide[-1] == 260_832
    assert 4 * tabs.arena.numel() == 199_856
    assert _budget(tabs) == 230_064
    assert walk.launch_plan(tabs, CARD) == (nsteps, tabs.arena.numel())
    assert walk.fixed_smem_bytes(nsteps) + 199_856 <= sieve.SMEM_LIMIT
    assert bisect.bisect_right(wide, _budget(tabs) // 4) == 44


@pytest.mark.parametrize("name", ["f1", "snort_3000"])
def test_overflowing_image_keeps_a_longer_prefix(walk_sets, name):
    # where the tables do not fit whole, K2 keeps at least as many whole
    # tables as 32-bit values would have left it, within its budget
    eng = _engine(walk_sets, name)
    tabs = eng._walk
    budget = _budget(tabs)
    resident = walk.launch_plan(tabs, CARD)[1]
    assert 0 < resident < tabs.arena.numel() and 4 * resident <= budget
    tables = bisect.bisect_right(walk.table_ends(tabs), resident)
    old = bisect.bisect_right(_wide_ends(eng.walk_tables), budget // 4)
    assert tables >= old
    if name == "snort_3000":
        assert old > 0 and tables > old


@pytest.mark.parametrize("name,more", [("snort", True), ("f1", False),
                                       ("snort_3000", True)])
def test_k3_prefix_holds_at_least_the_wide_tables(walk_sets, monkeypatch,
                                                  name, more):
    # K3 at 64 and 192 MiB on a 132-SM card reads the same layout: its
    # resident prefix holds at least as many whole tables as 32-bit values
    # would have left it (the Snort-like set 45-46 against 26); the F1
    # set's entry table fits neither
    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    eng = _engine(walk_sets, name)
    tabs = eng._walk
    for mb in (64, 192):
        ntiles = npad_for(mb << 20) // block_walk.CHUNK
        nsteps, _, cap, resident = block_walk.launch_plan(tabs, ntiles, CARD)
        budget = sieve.SMEM_LIMIT - block_walk.fixed_smem_bytes(nsteps, cap)
        assert 4 * resident <= budget and resident < tabs.arena.numel()
        tables = bisect.bisect_right(walk.table_ends(tabs), resident)
        old = bisect.bisect_right(_wide_ends(eng.walk_tables), budget // 4)
        assert tables >= old and (tables > old) == more, (mb, tables, old)


@pytest.mark.parametrize("corpus", ["pattern_stream", "planted_text"])
def test_image_walk_equals_walk_plain(walk_sets, corpus):
    # 1 MiB of the Snort-like set's own patterns concatenated (the
    # virus-dense worst case) and of text with 1.5% planted copies: K1's
    # survivors walked over the layout as the kernels read it give the
    # golden model's matches of >= 4 bytes, and a count's first positions
    # theirs alone
    eng = _engine(walk_sets, "snort")
    tabs = eng._walk
    pats = IMAGE_SETS["snort"]()
    rng = np.random.default_rng(21)
    n = 1 << 20
    host = (rulesets.pattern_stream(rng, pats, n) if corpus == "pattern_stream"
            else rulesets.planted_text(rng, pats, n, 0.015))
    data = torch.from_numpy(host.copy())
    a = eng.automaton
    length = np.zeros(int(a.pattern_ids.max()) + 1, np.int64)
    length[a.pattern_ids] = [len(p) for p in a.sorted_patterns]
    ids = golden.match_dense_batch(a, host)
    deep = torch.from_numpy(np.where(length[ids] >= 4, ids, 0)
                            .astype(np.int32))
    _, bits, _ = sieve.sieve_plain(data, n, npad_for(n), eng._sieve)
    pos = torch.nonzero(sieve.unpack_bits(bits)[:n]).flatten().to(
        torch.int32)
    assert pos.numel() > 500 and int((deep > 0).sum()) > 100
    for count in (None, pos.numel() // 3):
        got = torch.zeros(n, dtype=torch.int32)
        walk.walk_plain(data, n, pos, got, tabs, None if count is None
                        else torch.tensor([count], dtype=torch.int32))
        walked = pos[:count].long()
        want = torch.zeros(n, dtype=torch.int32)
        want[walked] = deep[walked]
        assert torch.equal(got, want)
        if count is None:
            assert torch.equal(got, deep)      # every deep match survives

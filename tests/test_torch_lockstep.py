"""The lockstep walk's plain version (``pfac_tpu_torch.backends.lockstep``),
through the uint8 + n interface its kernel takes, against the reference's
``pfac_tpu.backends.xla`` on JAX's CPU: the same seeded numpy bytes in
dense and hash mode, bit-exact (tolerance 0); the compacted pair form the
kernel keeps in shared memory (``pair_form``, ``pair_lookup_plain``)
against the reference's ``pair_tables`` on every pair, and the placement
rule. The kernel itself is held against this plain version on the card
(``tests/test_torch_cuda.py``)."""
import jax
import numpy as np
import pytest
import torch

import pfac_tpu
import pfac_tpu_torch as pt
from pfac_tpu.backends import xla as ref
from pfac_tpu.dist import sharding as ref_sharding
from pfac_tpu_torch import trace
from pfac_tpu_torch.backends import lockstep, xla
from pfac_tpu_torch.dist.sharding import ShardedMatcher, make_data_mesh
from pfac_tpu_torch.experiments import rulesets

README = [b"AB", b"ABG", b"BEDE", b"ED"]


def _ruleset(seed, k=40, max_len=12, alpha=6):
    rng = np.random.default_rng(seed)
    letters = rng.integers(0, 256, size=alpha).astype(np.uint8)
    pats = [bytes(letters[rng.integers(0, alpha,
                                       size=int(rng.integers(1, max_len)))])
            for _ in range(k)]
    return pats, letters, rng


def _walk(pats, data, mode="dense", tile=64, n=None):
    """-> (plain walk over data[:n] of the port, the reference's
    match_device over the same bytes), both int32[num_tiles * tile]."""
    n = len(data) if n is None else n
    hashed = mode == "hash"
    a = pt.Automaton.from_patterns(pats, hashed=hashed)
    m = xla.XlaMatcher(a, perf_mode=mode, tile=tile, device="cpu")
    num_tiles, _ = xla._pad_len(n, tile, a.max_pattern_len)
    u8 = np.frombuffer(bytes(data), np.uint8)
    out = torch.empty(num_tiles * tile, dtype=torch.int32)
    got = lockstep.lockstep_walk_plain(
        torch.from_numpy(u8.copy()), n, out, m._tables, perf_mode=mode,
        num_final=a.num_final_states, max_len=a.max_pattern_len)
    ra = pfac_tpu.Automaton.from_patterns(pats, hashed=hashed)
    want = np.asarray(ref.XlaMatcher(ra, perf_mode=mode, tile=tile)
                      .match_device(u8[:n]))
    return got.numpy(), want


def _equal(pats, data, mode="dense", tile=64, n=None):
    got, want = _walk(pats, data, mode, tile, n)
    assert got.dtype == np.int32 and got.tolist() == want.tolist()
    return got


@pytest.mark.parametrize("mode", ["dense", "hash"])
@pytest.mark.parametrize("seed", range(4))
def test_seeded_rulesets(mode, seed):
    pats, letters, rng = _ruleset(seed)
    data = letters[rng.integers(0, len(letters), size=700)].tobytes()
    got = _equal(pats, data, mode, tile=128)
    assert got.any()


@pytest.mark.parametrize("mode", ["dense", "hash"])
@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 3 * 64 - 5])
def test_lengths(mode, n):
    # n of 1 and 2, tile - 1, a tile, tile + 1 and a cut last tile: the
    # tail past n is 0 and walks stop at n
    pats, letters, rng = _ruleset(100 + n, k=20, max_len=6, alpha=3)
    data = letters[rng.integers(0, 3, size=n)].tobytes()
    got = _equal(pats, data, mode, tile=64)
    assert got.shape[0] == -(-n // 64) * 64 and not got[n:].any()


@pytest.mark.parametrize("mode", ["dense", "hash"])
def test_bytes_past_n_are_not_read(mode):
    # a buffer longer than n walks as if it ended at n: the bytes past it
    # are the sentinel, even where they would extend a match
    pats, data = [b"abc", b"abcdef"], b"xxabcdef"
    for n, at2 in ((4, 0), (5, 1), (7, 1), (8, 2)):
        got = _equal(pats, data, mode, tile=16, n=n)
        assert got[2] == at2 and not got[n:].any()


@pytest.mark.parametrize("mode", ["dense", "hash"])
def test_max_len_two_or_less(mode):
    # max_len <= 2: the pair lookup alone, no step
    for pats in ([b"a"], [b"ab", b"b"], [b"ab", b"ba", b"b"]):
        _equal(pats, b"abbaab" * 11 + b"a", mode, tile=16)


@pytest.mark.parametrize("mode", ["dense", "hash"])
def test_duplicates_later_id_wins(mode):
    got = _equal([b"ab", b"ab", b"abcde", b"abcde", b"x", b"x", b"x"],
                 b"zabcdeabxx", mode, tile=8)
    assert got[:10].tolist() == [0, 4, 0, 0, 0, 0, 2, 0, 7, 7]


@pytest.mark.parametrize("mode", ["dense", "hash"])
def test_thousand_byte_pattern(mode):
    rng = np.random.default_rng(1000)
    long = rng.integers(0, 256, size=1000, dtype=np.uint8).tobytes()
    pats = [long, long[:3], long[500:504]]
    data = bytearray(rng.integers(0, 256, size=2600, dtype=np.uint8))
    data[100:1100] = long
    data[2000:2600] = long[:600]           # cut by the end of the input
    got = _equal(pats, bytes(data), mode, tile=256)
    assert got[100] == 1 and got[2000] == 2 and got[600] == 3


@pytest.mark.parametrize("mode", ["dense", "hash"])
def test_conformance_example(mode):
    got = _equal(README, b"ABEDEDABG", mode, tile=16)
    assert got[:9].tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]


def _negative_key_tables(seed, states=40, num_final=12):
    """Synthetic hash tables whose keys all have k >= 32768 (a negative
    int32 key), built by the probe's own arithmetic so that walks go
    deep, with pair tables over them (the sentinel's row and column 0)."""
    rng = np.random.default_rng(seed)
    slots = 256
    e = states * slots
    rp_off = np.arange(states, dtype=np.int64) * slots
    k = rng.integers(32768, 65536, size=states)
    rp_key = ((k << 16) | (slots - 1)).astype(np.uint32).view(np.int32)
    rp_off[0], rp_key[0] = e, 0               # state 0 probes the poison
    val_next = np.zeros(e + 1, np.int32)
    val_ch = np.full(e + 1, -1, np.int32)
    letters = np.arange(60, 66)
    for s in range(1, states):
        key = np.int32(rp_key[s])
        for ch in rng.choice(letters, size=3, replace=False):
            x = (key >> 16) * np.int32(ch)
            beta = (x & 0xFF) - (x >> 8)
            beta = beta + 257 if beta < 0 else beta
            slot = int(rp_off[s]) + int(beta & (key & 0xFFFF))
            val_ch[slot] = ch
            val_next[slot] = rng.integers(0, states)
    pair_state = rng.integers(0, states, size=257 * 257).astype(np.int32)
    pair_match = rng.integers(0, num_final + 1,
                              size=257 * 257).astype(np.int32)
    for t in (pair_state, pair_match):
        t.reshape(257, 257)[256, :] = 0
        t.reshape(257, 257)[:, 256] = 0
    data = rng.choice(letters, size=500).astype(np.uint8)
    return (pair_state, pair_match, rp_off.astype(np.int32), rp_key,
            val_next, val_ch), data


@pytest.mark.parametrize("seed", [0, 1])
def test_hash_key_with_k_past_32767(seed):
    # no ruleset yields a key with k >= 32768 (k <= 256), so synthetic
    # tables go to both packages' walks: the shift is arithmetic there
    tables, data = _negative_key_tables(seed)
    assert (tables[3][1:] < 0).all()
    kw = dict(num_final=12, max_len=9)
    tile, n = 128, 450
    want = np.asarray(ref._match_hash_padded(
        *(jax.numpy.asarray(t) for t in tables[2:]),
        jax.numpy.asarray(tables[0]), jax.numpy.asarray(tables[1]),
        data[:n], tile=tile, num_tiles=4, **kw))
    out = torch.empty(4 * tile, dtype=torch.int32)
    got = lockstep.lockstep_walk_plain(
        torch.from_numpy(data), n, out,
        tuple(torch.from_numpy(t) for t in tables), perf_mode="hash", **kw)
    assert got.numpy().tolist() == want.tolist()
    assert (got > 0).sum() > 10


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == 8, "conftest must force 8 virtual CPU devices"
    return (make_data_mesh(devices=["cpu"] * 8),
            ref_sharding.make_data_mesh(8))


@pytest.mark.parametrize("mode", ["dense", "hash"])
def test_sharded_walker_shard_plus_halo(meshes, mode):
    # the sharded walker hands each shard's buffer (its bytes and the next
    # shard's head) to XlaMatcher._walk with its valid length: equal to the
    # reference's sharded walker, and each shard to the walk of the whole
    pats, letters, rng = _ruleset(7, k=30, max_len=20, alpha=4)
    data = letters[rng.integers(0, 4, size=8 * 32 - 11)].tobytes()
    hashed = mode == "hash"
    sm = ShardedMatcher(pt.Automaton.from_patterns(pats, hashed=hashed),
                        mesh=meshes[0], perf_mode=mode, tile=32,
                        engine="xla")
    rs = ref_sharding.ShardedMatcher(
        pfac_tpu.Automaton.from_patterns(pats, hashed=hashed),
        mesh=meshes[1], perf_mode=mode, tile=32, engine="xla")
    got = sm.match(data)
    assert got.tolist() == np.asarray(rs.match(data)).tolist()
    whole, _ = _walk(pats, data, mode, tile=32)
    assert got.tolist() == whole[:len(data)].tolist()
    n, sl = len(data), sm._shard_len(len(data))
    bufs = sm._put(np.frombuffer(data, np.uint8), sl)
    sm._exchange_halos(bufs, sl)
    eng = sm._engines[torch.device("cpu")]
    for g, buf in enumerate(bufs):
        res = eng._walk(buf, sm._n_valid(g, sl, n), sl // 32)
        assert res.tolist() == whole[g * sl:(g + 1) * sl].tolist()


def test_lockstep_walk_on_the_cpu_is_the_plain_version():
    a = pt.Automaton.from_patterns(README)
    m = xla.XlaMatcher(a, tile=16, device="cpu")
    data = torch.frombuffer(bytearray(b"ABEDEDABG"), dtype=torch.uint8)
    before = trace.launches(*lockstep.KERNELS.values())
    kw = dict(perf_mode="dense", num_final=a.num_final_states,
              max_len=a.max_pattern_len)
    got = lockstep.lockstep_walk(data, 9, torch.empty(16, dtype=torch.int32),
                                 m._tables, **kw)
    want = lockstep.lockstep_walk_plain(
        data, 9, torch.full((16,), 99, dtype=torch.int32), m._tables, **kw)
    assert torch.equal(got, want) and trace.launches(
        *lockstep.KERNELS.values()) == before
    assert got[:9].tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]


def test_arguments_checked():
    a = pt.Automaton.from_patterns(README)
    m = xla.XlaMatcher(a, tile=16, device="cpu")
    data = torch.zeros(9, dtype=torch.uint8)
    out = torch.empty(16, dtype=torch.int32)
    kw = dict(num_final=4, max_len=4)
    for args, mode in (
            ((data.int(), 9, out, m._tables), "dense"),
            ((data, 10, out, m._tables), "dense"),
            ((data, 9, out.long(), m._tables), "dense"),
            ((data, 9, out, m._tables), "hash"),
            ((data, 9, out, m._tables), "sparse"),
            ((data[::2], 5, out, m._tables), "dense"),
            ((data, 9, out, (m._tables[0][1:], *m._tables[1:])), "dense")):
        with pytest.raises(ValueError):
            lockstep.lockstep_walk(*args, perf_mode=mode, **kw)


def test_bound_bytes():
    # the input read once and 4 B written a position: 5 B a position, so
    # 0.200 ms at 128 Mi positions and 3.35 TB/s
    npad = 128 << 20
    assert lockstep.bound_bytes(npad, npad) == 5 * npad
    assert round(lockstep.bound_bytes(npad, npad) / 3.35e12 * 1e3, 3) == 0.2
    assert lockstep.bound_bytes(1024, 1000) == 1000 + 4 * 1024
    assert lockstep.bound_bytes(64, 0) == 256


def test_xla_matcher_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = pt.Automaton.from_patterns(README)
    with pytest.raises(pt.PfacError, match="no GPU"):
        xla.XlaMatcher(a)
    with pytest.raises(pt.PfacError, match="no GPU"):
        xla.XlaMatcher(a, device="cuda:0")
    assert xla.XlaMatcher(a, device="cpu").device == torch.device("cpu")


def _pair_sets():
    rng = np.random.default_rng(256)
    every_first = [bytes([b]) + rng.integers(0, 256, size=int(k),
                                             dtype=np.uint8).tobytes()
                   for b, k in zip(range(256), rng.integers(0, 4, size=256))]
    return {
        "conformance": README,
        # a match after one byte at every first byte: m1 is a whole row
        "one_byte": [bytes([b]) for b in range(256)] + [b"ab", b"abc"],
        "duplicates": [b"ab", b"ab", b"abcde", b"abcde", b"x", b"x", b"xy"],
        "snort": rulesets.snort_like_patterns(),
        "all_first_bytes": every_first,
    }


@pytest.mark.parametrize("name", ["conformance", "one_byte", "duplicates",
                                  "snort", "all_first_bytes"])
def test_pair_form_equals_reference_pair_tables(name):
    # the compacted form and the m2 derived from it (m1 = pair_match's
    # column 256) equal the reference's pair tables on all 257 x 257 pairs
    pats = _pair_sets()[name]
    a = pt.Automaton.from_patterns(pats)
    want_s, want_m = ref.pair_tables(pfac_tpu.Automaton.from_patterns(pats))
    ps, pm = xla.pair_tables(a)
    form = lockstep.pair_form(ps)
    assert form.dtype == np.int32
    assert form.shape[0] == lockstep.FORM_HEAD + int((want_s != 0).sum())
    c = torch.arange(257)
    s2, m2 = lockstep.pair_lookup_plain(
        torch.from_numpy(form), torch.from_numpy(pm), a.num_final_states,
        c.repeat_interleave(257), c.repeat(257))
    assert s2.dtype == m2.dtype == torch.int32
    assert np.array_equal(s2.numpy(), np.asarray(want_s))
    assert np.array_equal(m2.numpy(), np.asarray(want_m))
    if name == "one_byte":
        assert (np.asarray(want_m).reshape(257, 257)[:256, 256] > 0).all()
    if name == "all_first_bytes":
        assert (np.asarray(want_s).reshape(257, 257)[:256].any(axis=1)
                | (np.asarray(want_m).reshape(257, 257)[:256, 256] > 0)).all()


def test_pair_form_refuses_a_live_sentinel():
    ps = np.zeros(257 * 257, np.int32)
    ps[256 * 257 + 3] = 5
    with pytest.raises(ValueError, match="sentinel"):
        lockstep.pair_form(ps)
    ps[:] = 0
    ps[3 * 257 + 256] = 5
    with pytest.raises(ValueError, match="sentinel"):
        lockstep.pair_form(ps)


def test_placement_rule():
    # the Snort set's form goes to shared memory; a set whose nonzero pairs
    # pass the budget goes through L1/L2; its form forced on the kernel
    # raises
    snort = pt.Automaton.from_patterns(rulesets.snort_like_patterns())
    m = xla.XlaMatcher(snort, device="cpu")
    assert m.placement == "smem" and m._pairs is not None
    assert 4 * m._pairs.shape[0] <= lockstep.PAIR_SMEM_BYTES
    rng = np.random.default_rng(20_000)
    wide = list(dict.fromkeys(
        bytes(r) for r in rng.integers(0, 256, size=(20_000, 3),
                                       dtype=np.uint8)))
    a = pt.Automaton.from_patterns(wide)
    form = lockstep.pair_form(xla.pair_tables(a)[0])
    assert 4 * form.shape[0] > lockstep.PAIR_SMEM_BYTES
    assert lockstep.placement_for(form) == "global"
    w = xla.XlaMatcher(a, device="cpu")
    assert w.placement == "global" and w._pairs is None
    assert lockstep.placement_for(None) == "global"
    data = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(ValueError, match="budget"):
        lockstep.lockstep_walk(
            data, 16, torch.empty(16, dtype=torch.int32), w._tables,
            perf_mode="dense", num_final=a.num_final_states,
            max_len=a.max_pattern_len, pairs=torch.from_numpy(form))


@pytest.mark.parametrize("mode", ["dense", "hash"])
@pytest.mark.parametrize("placement", ["smem", "global"])
def test_xla_matcher_each_placement_equals_reference(mode, placement):
    # the walk on the CPU with the compacted form and without it (the plain
    # walk either way) equals the JAX XlaMatcher, Snort set over planted
    # text
    pats = rulesets.snort_like_patterns()
    rng = np.random.default_rng(13)
    data = rulesets.planted_text(rng, pats, 20_000, 0.05)
    a = pt.Automaton.from_patterns(pats, hashed=mode == "hash")
    m = xla.XlaMatcher(a, perf_mode=mode, tile=4096, device="cpu")
    assert m.placement == "smem"
    got = lockstep.lockstep_walk(
        torch.from_numpy(data), data.shape[0],
        torch.empty(m.match_device(torch.from_numpy(data)).shape[0],
                    dtype=torch.int32), m._tables, perf_mode=mode,
        num_final=a.num_final_states, max_len=a.max_pattern_len,
        pairs=m._pairs if placement == "smem" else None)
    ra = pfac_tpu.Automaton.from_patterns(pats, hashed=mode == "hash")
    want = np.asarray(ref.XlaMatcher(ra, perf_mode=mode, tile=4096)
                      .match_device(data))
    assert got.numpy().tolist() == want.tolist() and (want > 0).sum() > 100


def test_compacted_form_argument_checked():
    a = pt.Automaton.from_patterns(README)
    m = xla.XlaMatcher(a, tile=16, device="cpu")
    data = torch.zeros(9, dtype=torch.uint8)
    out = torch.empty(16, dtype=torch.int32)
    kw = dict(perf_mode="dense", num_final=4, max_len=4)
    for bad in (m._pairs.long(), m._pairs[:100], m._pairs[::2]):
        with pytest.raises(ValueError, match="compacted pair form"):
            lockstep.lockstep_walk(data, 9, out, m._tables, pairs=bad, **kw)
    got = lockstep.lockstep_walk(data, 9, out, m._tables, pairs=m._pairs,
                                 **kw)
    assert not got.any()

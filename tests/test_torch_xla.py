"""The port's lockstep walker (``pfac_tpu_torch.backends.xla``) against the
reference's ``pfac_tpu.backends.xla`` on JAX's CPU and the golden model, on
the same seeded inputs, bit-exact (tolerance 0): the counterparts of
``tests/test_xla.py``."""
import numpy as np
import pytest
import torch

import pfac_tpu
import pfac_tpu_torch as pt
from pfac_tpu import Automaton as RefAutomaton
from pfac_tpu.backends import golden
from pfac_tpu.backends import xla as ref
from pfac_tpu_torch.backends import xla

README = [b"AB", b"ABG", b"BEDE", b"ED"]


def _rand_case(seed, max_pat=10, max_len=8, n_lo=1, n_hi=400):
    rng = np.random.default_rng(seed)
    alpha = rng.integers(0, 256, size=int(rng.integers(2, 6))).astype(np.uint8)
    k = int(rng.integers(1, max_pat + 1))
    pats = [
        bytes(alpha[rng.integers(0, len(alpha), size=int(rng.integers(1, max_len)))])
        for _ in range(k)
    ]
    data = bytes(alpha[rng.integers(0, len(alpha), size=int(rng.integers(n_lo, n_hi)))])
    return pats, data


def _both(pats, data, mode="dense", tile=128, **kw):
    """-> (port, reference, golden) results of match(data)."""
    a = pt.Automaton.from_patterns(pats, **kw)
    ra = RefAutomaton.from_patterns(pats, **kw)
    got = xla.XlaMatcher(a, perf_mode=mode, tile=tile, device="cpu").match(data)
    want = np.asarray(ref.XlaMatcher(ra, perf_mode=mode, tile=tile).match(data))
    return got, want, golden.match_dense(ra, data)


def _equal(pats, data, mode="dense", tile=128, **kw):
    got, want, gold = _both(pats, data, mode, tile, **kw)
    assert got.dtype == np.int32
    assert got.tolist() == want.tolist() == gold.tolist()
    return got


@pytest.mark.parametrize("seed", [None, 0, 1, 2, 3])
def test_host_tables_equal_reference(seed):
    pats = README if seed is None else _rand_case(seed, max_pat=30)[0]
    a, ra = pt.Automaton.from_patterns(pats), RefAutomaton.from_patterns(pats)
    assert np.array_equal(xla.dense_device_table(a), ref.dense_device_table(ra))
    for x, y in zip(xla.pair_tables(a), ref.pair_tables(ra)):
        assert np.array_equal(x, y)
    h, rh = xla.hash_device_tables(a), ref.hash_device_tables(ra)
    assert h.keys() == rh.keys()
    for k in h:
        assert h[k].dtype == rh[k].dtype and np.array_equal(h[k], rh[k])
    assert (xla.SENTINEL, xla.STRIDE, xla.DEFAULT_TILE) == (
        ref.SENTINEL, ref.STRIDE, ref.DEFAULT_TILE)
    for n in (0, 1, 63, 64, 65, 1000):
        assert xla._pad_len(n, 64, a.max_pattern_len) == ref._pad_len(
            n, 64, ra.max_pattern_len)


@pytest.mark.parametrize("mode", ["dense", "hash"])
def test_readme_example(mode, example_pattern_path, example_input):
    a = pt.Automaton.from_pattern_file(example_pattern_path,
                                       hashed=mode == "hash")
    m = xla.XlaMatcher(a, perf_mode=mode, tile=256, device="cpu")
    assert m.match(example_input).tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0, 0]
    ids, pos, n = m.match_reduce(example_input)
    assert (n, pos.tolist(), ids.tolist()) == (5, [0, 1, 2, 4, 6],
                                               [1, 3, 4, 4, 2])


@pytest.mark.parametrize("mode", ["dense", "hash"])
@pytest.mark.parametrize("seed", range(8))
def test_random_vs_reference(mode, seed):
    pats, data = _rand_case(seed)
    _equal(pats, data, mode, hashed=mode == "hash")


@pytest.mark.parametrize("tile", [8, 16, 64, 512])
def test_multi_tile_boundary(tile):
    # matches that span tile boundaries resolve through the padded reads
    _equal([b"abcd", b"bc"], b"xabcdx" * 50, tile=tile)


@pytest.mark.parametrize("n", [63, 64, 65, 127, 128, 129])
def test_lengths_around_tile_multiples(n):
    rng = np.random.default_rng(n)
    pats = [b"ab", b"abc", b"abcdabcd", b"d"]
    data = bytes(rng.integers(97, 101, size=n, dtype=np.uint8))
    for mode in ("dense", "hash"):
        _equal(pats, data, mode, tile=64)
    # match_device's padded length and tail are the reference's
    a, ra = pt.Automaton.from_patterns(pats), RefAutomaton.from_patterns(pats)
    u8 = np.frombuffer(data, np.uint8)
    out = xla.XlaMatcher(a, tile=64, device="cpu").match_device(
        torch.from_numpy(u8.copy()))
    want = np.asarray(ref.XlaMatcher(ra, tile=64).match_device(u8))
    assert out.dtype == torch.int32 and out.numpy().tolist() == want.tolist()
    assert out.shape[0] == -(-n // 64) * 64 and not out[n:].any()


def test_input_shorter_than_tile():
    a = pt.Automaton.from_patterns([b"ab"])
    m = xla.XlaMatcher(a, perf_mode="dense", tile=1024, device="cpu")
    assert m.match(b"ab").tolist() == [1, 0]
    assert m.match(b"a").tolist() == [0]
    assert m.match(b"").tolist() == []
    out = m.match_device(torch.zeros(0, dtype=torch.uint8))
    assert out.shape[0] == 1024 and not out.any()


def test_single_byte_patterns():
    got = _equal([b"x", b"y"], b"xyzzyx", tile=16)
    assert got.tolist() == [1, 2, 0, 0, 2, 1]


@pytest.mark.parametrize("mode", ["dense", "hash"])
def test_long_walk_pattern(mode):
    # a walk of 26 steps: several compactions of the live lanes
    pat = bytes(range(65, 91))
    _equal([pat], b"123" + pat + b"45" + pat[:10], mode, tile=32)


@pytest.mark.parametrize("mode", ["dense", "hash"])
def test_max_len_two_or_less(mode):
    # max_len <= 2: the pair gather alone, no step past it
    for pats in ([b"a"], [b"a", b"ab"], [b"ab", b"ba", b"b"]):
        _equal(pats, b"abbaab" * 7 + b"a", mode, tile=16)


@pytest.mark.parametrize("mode", ["dense", "hash"])
def test_duplicates_later_id_wins(mode):
    got = _equal([b"ab", b"ab", b"abcde", b"abcde", b"x", b"x", b"x"],
                  b"zabcdeabxx", mode, tile=8)
    assert got.tolist() == [0, 4, 0, 0, 0, 0, 2, 0, 7, 7]


def test_pieces_cross_tiles(monkeypatch):
    # walk in pieces smaller than a tile and not dividing it: the result
    # does not depend on the piece
    pats, data = _rand_case(11, max_pat=20, max_len=12, n_lo=500, n_hi=900)
    want = _equal(pats, data, tile=128)
    monkeypatch.setattr(xla, "PIECE", 77)
    monkeypatch.setattr(xla, "COMPACT_EVERY", 3)
    for mode in ("dense", "hash"):
        got, _, _ = _both(pats, data, mode, tile=128)
        assert got.tolist() == want.tolist()


def test_empty_and_trap_only_input():
    a = pt.Automaton.from_patterns([b"zz"])
    m = xla.XlaMatcher(a, tile=32, device="cpu")
    assert m.match(b"").tolist() == []
    ids, pos, n = m.match_reduce(b"aaaaaaa")
    assert n == 0 and ids.tolist() == [] and pos.tolist() == []


@pytest.mark.parametrize("seed", range(4))
def test_reduce_vs_reference(seed):
    pats, data = _rand_case(seed)
    a, ra = pt.Automaton.from_patterns(pats), RefAutomaton.from_patterns(pats)
    g_ids, g_pos, g_n = golden.reduce_result(golden.match_dense(ra, data))
    ids, pos, n = xla.XlaMatcher(a, tile=64, device="cpu").match_reduce(data)
    assert (n, pos.tolist(), ids.tolist()) == (g_n, g_pos.tolist(),
                                               g_ids.tolist())
    u8 = np.frombuffer(data, np.uint8)
    d_ids, d_pos, d_n = xla.XlaMatcher(
        a, tile=64, device="cpu").match_reduce_device(
        torch.from_numpy(u8.copy()))
    r_ids, r_pos, r_n = ref.XlaMatcher(ra, tile=64).match_reduce_device(u8)
    assert d_n.dim() == 0 and d_n.dtype == torch.int32 and int(d_n) == int(r_n)
    assert d_ids.numpy().tolist() == np.asarray(r_ids).tolist()
    assert d_pos.numpy().tolist() == np.asarray(r_pos).tolist()


def test_all_positions_match():
    a = pt.Automaton.from_patterns([b"a"])
    ids, pos, n = xla.XlaMatcher(a, tile=8, device="cpu").match_reduce(b"aaaa")
    assert n == 4 and pos.tolist() == [0, 1, 2, 3] and ids.tolist() == [1] * 4


def test_device_mismatch_and_dtype_raise():
    m = xla.XlaMatcher(pt.Automaton.from_patterns(README), tile=16,
                       device="cpu")
    with pytest.raises(pt.PfacError):
        m.match_device(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        xla.XlaMatcher(pt.Automaton.from_patterns(README), perf_mode="x",
                       device="cpu")


def test_pair_tables_without_trie_equal_reference():
    # an automaton without its trie builds the pair tables from the dense
    # table, as the reference does
    a = pt.Automaton.from_patterns(README)
    ra = RefAutomaton.from_patterns(README)
    a.ensure_dense()
    a.trie = None
    for x, y in zip(xla.pair_tables(a), ref.pair_tables(ra)):
        assert np.array_equal(x, y)
    assert np.array_equal(xla.dense_device_table(a),
                          ref.dense_device_table(ra))


def test_hash_mode_row_of_256_raises_like_reference():
    # both packages' hash tables refuse a state with 256 transitions (the
    # C library's slot schedule stops at 255); dense mode serves it
    pats = [bytes([i, 65]) for i in range(256)]
    with pytest.raises(pt.PfacError, match="256 transitions"):
        xla.XlaMatcher(pt.Automaton.from_patterns(pats), perf_mode="hash",
                       device="cpu")
    with pytest.raises(pfac_tpu.PfacError, match="256 transitions"):
        ref.XlaMatcher(RefAutomaton.from_patterns(pats), perf_mode="hash")
    data = bytes(range(256)) + b"A\x07A"
    _equal(pats, data, "dense", tile=64)

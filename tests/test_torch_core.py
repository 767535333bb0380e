"""The port's copies of the reference's host layers against the reference,
on seeded rulesets (tolerance 0): the automaton's arrays and its dense and
hash tables, the CHD builders' parameters and slots, the native builds
against the pure-Python ones, the golden model, the status codes, the
stream matcher, and the rulesets the card runs use."""
import numpy as np
import pytest

import bench
import pfac_tpu.backends.golden as ref_golden
import pfac_tpu.core.chd as ref_chd
import pfac_tpu.status as ref_status
from pfac_tpu.core.automaton import Automaton as RefAutomaton
from pfac_tpu_torch import status
from pfac_tpu_torch.backends import golden
from pfac_tpu_torch.core import chd, native, parser
from pfac_tpu_torch.core.automaton import Automaton
from pfac_tpu_torch.experiments import rulesets


def _rulesets():
    out = [[b"AB", b"ABG", b"BEDE", b"ED"],
           [b"s", b"h", b"he", b"she", b"hers", b"her", b"his", b"dup",
            b"dup", b"\x00\x01", b"\xff\xfe"]]
    for seed in range(3):
        rng = np.random.default_rng(seed)
        out.append([bytes(rng.integers(0, 256, size=int(rng.integers(1, 20)),
                                       dtype=np.uint8))
                    for _ in range(int(rng.integers(20, 300)))])
    return out


RULESETS = _rulesets()


def _same_automaton(a, r):
    for f in ("num_states", "num_final_states", "initial_state",
              "num_leaves", "max_pattern_len", "sorted_patterns"):
        assert getattr(a, f) == getattr(r, f), f
    assert np.array_equal(a.pattern_ids, r.pattern_ids)
    assert np.array_equal(a.pattern_lens, r.pattern_lens)
    assert a.trie.rows == r.trie.rows
    assert np.array_equal(a.trie.edges_array(), r.trie.edges_array())


@pytest.mark.parametrize("k", range(len(RULESETS)))
def test_automaton_and_tables_equal_reference(k):
    pats = RULESETS[k]
    a, r = Automaton.from_patterns(pats), RefAutomaton.from_patterns(pats)
    _same_automaton(a, r)
    assert np.array_equal(a.ensure_dense().table, r.ensure_dense().table)
    h, rh = a.ensure_hash(), r.ensure_hash()
    assert np.array_equal(h.row_ptr, rh.row_ptr)
    assert np.array_equal(h.val, rh.val)
    if all(32 <= c <= 126 for p in pats for c in p):
        # both raise on a non-printable byte ({ch:4.2x}; ROADMAP.md §3)
        assert a.dump_transition_table() == r.dump_transition_table()
    for mode in ("dense", "hash"):
        assert a.memory_usage(mode) == r.memory_usage(mode)


def _keys(seed: int, n: int, bits: int = 32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, 1 << bits, size=n,
                                  dtype=np.int64)).astype(np.uint32)


def _same_chd(t, u):
    for f in ("num_slots", "num_buckets", "salt", "lg_slots"):
        assert getattr(t, f) == getattr(u, f), f
    assert getattr(t, "nodisp_mul", None) == getattr(u, "nodisp_mul", None)
    for f in ("disp", "slot_words"):
        x, y = getattr(t, f), getattr(u, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert np.array_equal(x, y), f


@pytest.mark.parametrize("seed,n", [(0, 40), (1, 700), (2, 5000)])
def test_chd_builders_equal_reference(seed, n):
    keys = _keys(seed, n)
    vals = (np.arange(keys.size) % 0x7FFF + 1).astype(np.uint32)
    keys16 = _keys(seed, min(n, 3000), bits=16)
    vals16 = (np.arange(keys16.size) % 0x7FFF + 1).astype(np.uint32)
    _same_chd(chd.build_resid2(keys, bits=16),
              ref_chd.build_resid2(keys, bits=16))
    _same_chd(chd.build_exact2(keys16, vals16),
              ref_chd.build_exact2(keys16, vals16))
    t, kw = chd.build_exact_wide2(keys, vals)
    u, ukw = ref_chd.build_exact_wide2(keys, vals)
    _same_chd(t, u)
    assert np.array_equal(kw, ukw)
    if keys.size <= 64:
        _same_chd(chd.build_exact2_nodisp(keys16, vals16),
                  ref_chd.build_exact2_nodisp(keys16, vals16))
        t, kw = chd.build_exact_wide2_nodisp(keys, vals)
        u, ukw = ref_chd.build_exact_wide2_nodisp(keys, vals)
        _same_chd(t, u)
        assert np.array_equal(kw, ukw)


@pytest.mark.parametrize("k", range(len(RULESETS)))
def test_native_equals_python_build(k):
    if not native.native_available():
        pytest.skip("no C++ toolchain for the native host compiler")
    data = b"\n".join(p.replace(b"\n", b"\x0b") for p in RULESETS[k]) + b"\n"
    py = Automaton.from_parsed(parser.parse_pattern_bytes(data))
    nat = Automaton._from_native(data)
    assert nat is not None
    _same_automaton(nat, py)
    _same_automaton(nat, RefAutomaton._from_native(data))


def test_native_chd_equals_python(monkeypatch):
    if not native.native_available():
        pytest.skip("no C++ toolchain for the native host compiler")
    keys = _keys(5, 2000)
    t_nat = chd.build_resid2(keys, bits=16)
    monkeypatch.setattr(native, "chd_assign", lambda *a, **k: NotImplemented)
    _same_chd(t_nat, chd.build_resid2(keys, bits=16))


def test_native_builds_into_the_port():
    if not native.native_available():
        pytest.skip("no C++ toolchain for the native host compiler")
    assert native._SO.endswith("pfac_tpu_torch/_build/libpfac_host.so")
    assert native._SRC.endswith("pfac_tpu_torch/native/pfac_host.cpp")


@pytest.mark.parametrize("k", range(len(RULESETS)))
def test_golden_equals_reference(k):
    pats = RULESETS[k]
    a, r = Automaton.from_patterns(pats), RefAutomaton.from_patterns(pats)
    rng = np.random.default_rng(k)
    alpha = np.frombuffer(b"".join(pats), np.uint8)
    data = alpha[rng.integers(0, alpha.size, size=3000)].tobytes()
    want = ref_golden.match_dense(r, data)
    assert golden.match_dense(a, data).tolist() == want.tolist()
    assert golden.match_hash(a, data).tolist() == want.tolist()
    assert golden.match_edges_batch(a, data, chunk=1000).tolist() == \
        ref_golden.match_edges_batch(r, data).tolist()
    got, ref = golden.reduce_result(want), ref_golden.reduce_result(want)
    assert got[2] == ref[2] and all(np.array_equal(x, y)
                                    for x, y in zip(got[:2], ref[:2]))
    assert golden.match_dense_batch(a, data, chunk=1000).tolist() == \
        ref_golden.match_dense_batch(r, data).tolist() == want.tolist()


def test_status_equals_reference():
    assert [(s.name, int(s)) for s in status.PfacStatus] == \
        [(s.name, int(s)) for s in ref_status.PfacStatus]
    for s in status.PfacStatus:
        assert status.get_error_string(s) == ref_status.get_error_string(int(s))


def test_rulesets_equal_the_bench_scripts():
    assert rulesets.snort_like_patterns(42) == bench.snort_like_patterns(42)
    assert rulesets.snort_like_patterns() == bench.snort_like_patterns()
    pats = rulesets.clamav_like_patterns(np.random.default_rng(7), k=500)
    assert len(pats) == 500 and all(8 <= len(p) <= 200 for p in pats)
    d = rulesets.mixed_density(np.random.default_rng(3), pats, 1 << 16, 8192)
    assert (d[8192:16384] == ord("z")).sum() > 8192 // 4
    t = rulesets.planted_text(np.random.default_rng(1), pats, 50_000, 0.02)
    assert t.dtype == np.uint8 and t.size == 50_000

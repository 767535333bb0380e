"""The port's flat tables against the reference package's, field by field.

``convert.from_jax_tables`` carries the reference's lane-replicated tables
across to the port's layout; both packages build from the same ``chd``
builders, so every multiplier (hence salt), lg_b, lg_r, displacement, key
and value must agree exactly. The reference-layout sizes that gate the tiers
must agree too, so both packages pick the same tier.
"""
import numpy as np
import pytest

import pfac_tpu.backends.pallas_sieve as S
from pfac_tpu.backends import pallas_walk as W
from pfac_tpu_torch.backends import block_walk, sieve
from pfac_tpu_torch.backends.convert import from_jax_tables
from pfac_tpu_torch.backends.sieve_tables import SieveTables
from pfac_tpu_torch.backends.walk_tables import build_walk_tables
from pfac_tpu_torch.core import Automaton


def _rand_pats(seed, k=40, lmin=1, lmax=14, alpha=256):
    rng = np.random.default_rng(seed)
    pats = [bytes(rng.integers(0, alpha, size=int(rng.integers(lmin, lmax + 1)),
                               dtype=np.uint8))
            for _ in range(k)]
    return list(dict.fromkeys(pats))


def _assert_probe_equal(a, b, where):
    assert (a is None) == (b is None), where
    if a is None:
        return
    assert (a.mul, a.lg_b, a.lg_r) == (b.mul, b.lg_b, b.lg_r), where
    for field in ("disp", "keys", "vals"):
        x, y = getattr(a, field), getattr(b, field)
        assert (x is None) == (y is None), (where, field)
        if x is not None:
            assert x.dtype == y.dtype == np.int32, (where, field)
            assert np.array_equal(x, y), (where, field)


def _assert_same_tables(pats):
    a = Automaton.from_patterns(pats)
    jst = S.SieveTables.build(a)
    jwt = W.build_walk_tables(a)
    cst, cwt = from_jax_tables(jst, jwt)
    st = SieveTables.build(a)
    assert np.array_equal(cst.m1, st.m1)
    for name in ("m2", "m3", "alive"):
        _assert_probe_equal(getattr(cst, name), getattr(st, name), name)
    assert cst.vmem_bytes == st.vmem_bytes
    wt = build_walk_tables(a)
    assert (cwt is None) == (wt is None)
    if wt is None:
        return st, wt
    assert cwt.max_len == wt.max_len and cwt.vmem_bytes == wt.vmem_bytes
    _assert_probe_equal(cwt.entry, wt.entry, "entry")
    _assert_probe_equal(cwt.entry_final, wt.entry_final, "entry_final")
    assert [s.depth for s in cwt.steps] == [s.depth for s in wt.steps]
    for cs, s in zip(cwt.steps, wt.steps):
        for name in ("main", "odd", "even"):
            _assert_probe_equal(getattr(cs, name), getattr(s, name),
                                (s.depth, name))
    return st, wt


def test_reference_defaults_match_the_port():
    # the port leaves behind the reference's switched-off arms and mirrors
    # its escape threshold and bucket: pin the reference defaults it relies on
    assert S.ALIVE_BUCKET2_MAX == 0
    assert S._RESID8_THRESHOLD >= 1 << 30
    assert S._ALIVE_CHD_MAX >= 1 << 30
    assert S._M1_CHAIN_MAX == 2
    assert S._WALK_VMEM_BUDGET == 6 << 20
    assert S.DENSE_ESCAPE_DIV == block_walk.DENSE_ESCAPE_DIV == 4
    assert S.TILE_ROWS == 512 and S.TILE_ROWS * S.LANES == sieve.BLOCK


@pytest.mark.parametrize("case", [
    "readme", "len1_only", "len1_chain2", "len1_table", "nodisp_small",
    "mixed_small", "binary",
])
def test_tables_equal(case):
    pats = {
        "readme": [b"AB", b"ABG", b"BEDE", b"ED"],
        "len1_only": [b"x", b"y", b"z", b"\x00", b"\xff"],
        "len1_chain2": [b"q", b"\x80", b"qwert", b"qw"],
        "len1_table": [b"a", b"b", b"c", b"x", b"ab", b"abc", b"abcdef"],
        "nodisp_small": [b"wxyzA", b"wxyzB", b"wxyz99", b"wxyQ", b"ab",
                         b"abc"],
        "mixed_small": _rand_pats(3, k=30),
        "binary": [bytes([0x80 | i, 0xFF, i, 0x90]) * (1 + i % 3)
                   for i in range(20)],
    }[case]
    _assert_same_tables(pats)


@pytest.mark.parametrize("seed", [0, 1])
def test_tables_equal_random_chd(seed):
    # > 64 keys per class: displacement CHD tables (u8 and u16 disp)
    pats = _rand_pats(100 + seed, k=600, lmin=2, lmax=6)
    st, wt = _assert_same_tables(pats)
    assert not st.m2.nodisp and not st.m3.nodisp and not wt.entry.nodisp


def test_tables_equal_wide_ids():
    # > 0x7FFF patterns: m1/m2 switch to the wide encoding; the walk
    # tables still hold (IDs < 2^16)
    rng = np.random.default_rng(9)
    keys = rng.choice(1 << 16, size=33000, replace=False)
    pats = [bytes([k >> 8, k & 0xFF]) for k in keys]
    pats += [b"a", b"b", b"c", b"XYZq", b"XYZqrs", b"XY\x81"]
    a = Automaton.from_patterns(pats)
    assert a.num_final_states > 0x7FFF
    st, _ = _assert_same_tables(pats)
    assert st.m2.keys is not None and not st.m2.nodisp


def test_duplicate_patterns_later_id_wins():
    pats = [b"ab", b"ab", b"abcd", b"abcd", b"q", b"q", b"q"]
    st, wt = _assert_same_tables(pats)
    assert st.m1[ord("q")] == 7
    assert wt.entry_final.lookup(int.from_bytes(b"abcd", "big")) == (True, 4)

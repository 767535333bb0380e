"""The whole slice on the CPU: ``pfac_tpu_torch.Matcher(device="cpu")``
against the reference ``SieveMatcher(interpret=True)`` and the golden model,
bit-exact (tolerance 0)."""
import numpy as np
import pytest
import torch

import pfac_tpu
import pfac_tpu_torch as pt
from pfac_tpu import Matcher as RefMatcher
from pfac_tpu.backends import golden
from pfac_tpu.backends import pallas as ref_pallas
from pfac_tpu.backends.pallas_sieve import SieveMatcher as RefSieveMatcher
from pfac_tpu.backends.xla import XlaMatcher as RefXlaMatcher
from pfac_tpu_torch.backends import (block_walk, compact, select, sieve,
                                     sieve_matcher)
from pfac_tpu_torch.backends.sieve_matcher import SieveMatcher, npad_for
from pfac_tpu_torch.backends.xla import XlaMatcher

README = [b"AB", b"ABG", b"BEDE", b"ED"]


def _check(pats, data: bytes, reference: bool = True, **kw):
    m = pt.Matcher(pats, device="cpu", **kw)
    got = m.match(data)
    want = golden.match_dense(m.automaton, data)
    assert got.dtype == np.int32 and got.tolist() == want.tolist()
    if reference:
        ref = RefSieveMatcher(m.automaton, interpret=True).match(data)
        assert got.tolist() == np.asarray(ref).tolist()
    return m, got


def test_conformance():
    m, got = _check(README, b"ABEDEDABG")
    assert got.tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]
    ids, pos, n = m.match_reduce(b"ABEDEDABG")
    assert (n, pos.tolist(), ids.tolist()) == (5, [0, 1, 2, 4, 6],
                                               [1, 3, 4, 4, 2])


def test_match_device_contract():
    m = pt.Matcher(README, device="cpu")
    data = torch.from_numpy(np.frombuffer(b"ABEDEDABG" * 3, np.uint8).copy())
    out = m.match_device(data)
    assert out.dtype == torch.int32 and out.shape[0] == npad_for(27) == 65536
    assert out[:9].tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]
    assert not out[27:].any()
    ids, pos, cnt = m.match_reduce_device(data)
    c = int(cnt)
    g_ids, g_pos, g_n = golden.reduce_result(out[:27].numpy())
    assert c == g_n and pos[:c].tolist() == g_pos.tolist()
    assert ids[:c].tolist() == g_ids.tolist() and not ids[c:].any()
    m.flush_checks()


def test_duplicates_later_id_wins():
    _, got = _check([b"ab", b"ab", b"abcde", b"abcde", b"x", b"x", b"x"],
                    b"zabcdeabxx")
    assert got.tolist() == [0, 4, 0, 0, 0, 0, 2, 0, 7, 7]


@pytest.mark.parametrize("n", [65535, 65536, 65537])
def test_lengths_at_grid_multiples(n):
    rng = np.random.default_rng(n)
    pats = [b"ab", b"abc", b"abcd", b"d", b"abcdabcdab"]
    data = bytearray(rng.integers(97, 101, size=n, dtype=np.uint8).tobytes())
    data[-4:] = b"abcd"
    m = pt.Matcher(pats, device="cpu")
    got = m.match(bytes(data))
    assert got.tolist() == golden.match_edges_batch(m.automaton,
                                                    bytes(data)).tolist()


def test_dense_block_survivors():
    # more than a quarter of a block survives: the port, like the
    # reference, walks the whole block through the dense-block escape
    rng = np.random.default_rng(5)
    pats = [b"aaaa", b"aaaab", b"aaaaaaab", b"aaba", b"ab", b"a"]
    data = bytes(rng.choice(np.frombuffer(b"aaaaaaaaab", np.uint8), 4000))
    m, _ = _check(pats, data, tile=8192)   # the reference's 64-row tile
    eng = m._engine()
    n, npad = len(data), npad_for(len(data), eng.tile_rows)
    t = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    match, bits, counts = sieve.sieve(t, n, npad, eng._sieve, 8192)
    assert int(counts[0]) > 8192 // 4
    assert block_walk.escaped_blocks(counts, npad) == 1
    block_walk.block_walk(t, n, counts, match, eng._walk)
    # compaction lists no survivor of the escaped block
    assert compact.compact(bits, counts, 8192 // 4)[0].numel() == 0
    assert match[:n].tolist() == m.match(data).tolist()


def test_random_rulesets_vs_golden():
    for seed in range(4):
        rng = np.random.default_rng(seed)
        alpha = rng.integers(0, 256, size=int(rng.integers(2, 6))).astype(np.uint8)
        pats = [bytes(alpha[rng.integers(0, len(alpha),
                                         size=int(rng.integers(1, 12)))])
                for _ in range(int(rng.integers(1, 30)))]
        data = bytes(alpha[rng.integers(0, len(alpha),
                                        size=int(rng.integers(1, 2000)))])
        _check(pats, data, reference=False)


def test_stream_equals_whole():
    rng = np.random.default_rng(3)
    pats = [b"HELLO", b"HELLOWORLD", b"LOW", b"W"]
    data = bytearray(rng.integers(65, 91, size=5000, dtype=np.uint8).tobytes())
    for off in (0, 997, 998, 2000, 4990):
        data[off:off + 10] = b"HELLOWORLD"
    data = bytes(data)
    m = pt.Matcher(pats, device="cpu")
    sm = m.stream(min_batch=256)
    out = []
    for off in range(0, len(data), 1000):
        out.append(sm.feed(data[off:off + 1000])[1])
    out.append(sm.finish()[1])
    assert np.concatenate(out).tolist() == golden.match_dense(
        m.automaton, data).tolist()


def test_platform_cpu_and_golden_backend():
    data = b"ABEDEDABG"
    for kw in ({"platform": "cpu"}, {"backend": "golden"}):
        m = pt.Matcher(README, device="cpu", **kw)
        assert m.match(data).tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]


def test_wide_ruleset_takes_the_csr_tier():
    # walk tables past their budget (> 6 MB in the reference layout): the
    # CSR tier serves the ruleset, as in the reference
    rng = np.random.default_rng(1)
    pats = [bytes(rng.integers(0, 256, size=80, dtype=np.uint8))
            for _ in range(3000)]
    m = pt.Matcher(pats, device="cpu")
    eng = m._engine()
    assert eng.walk_tables is None and eng.csr_tables is not None
    data = bytearray(rng.integers(0, 256, size=20000, dtype=np.uint8).tobytes())
    for off in range(0, 19900, 997):
        data[off:off + 80] = pats[int(rng.integers(0, len(pats)))]
    data += pats[8] + pats[7][:79]         # one whole, one cut by the end
    got = m.match(bytes(data))
    want = golden.match_edges_batch(m.automaton, bytes(data))
    assert got.tolist() == want.tolist() and (got > 0).sum() >= 20


LOCKSTEP_TIERS = {"xla": {"backend": "xla"},
                  "cpu_parallel": {"platform": "cpu_parallel"},
                  "hbm": {"placement": "hbm"}}


def _lockstep_equal(kw, mode, monkeypatch=None):
    rng = np.random.default_rng(9)
    pats = README + [bytes(rng.integers(65, 70, size=int(k), dtype=np.uint8))
                     for k in rng.integers(1, 14, size=40)]
    data = bytes(rng.integers(65, 70, size=3000, dtype=np.uint8)) + b"ABEDEDABG"
    m = pt.Matcher(pats, device="cpu", perf_mode=mode, tile=64, **kw)
    assert isinstance(m._engine(), XlaMatcher)
    ref = RefMatcher(pats, perf_mode=mode, tile=64, **kw)
    assert isinstance(ref._engine(), RefXlaMatcher)
    got, want = m.match(data), ref.match(data)
    assert got.tolist() == want.tolist() == golden.match_dense(
        m.automaton, data).tolist()
    ids, pos, n = m.match_reduce(data)
    r_ids, r_pos, r_n = ref.match_reduce(data)
    assert (n, pos.tolist(), ids.tolist()) == (r_n, r_pos.tolist(),
                                               r_ids.tolist())
    u8 = np.frombuffer(data, np.uint8)
    out = m.match_device(torch.from_numpy(u8.copy()))
    assert out.numpy().tolist() == np.asarray(ref.match_device(u8)).tolist()
    return m


@pytest.mark.parametrize("mode", ["dense", "hash"])
@pytest.mark.parametrize("tier", LOCKSTEP_TIERS)
def test_lockstep_tiers_equal_reference(tier, mode):
    # Backend.XLA, Platform.CPU_PARALLEL and PlacementMode.HBM take the
    # lockstep walker, as in the reference
    _lockstep_equal(LOCKSTEP_TIERS[tier], mode)


@pytest.mark.parametrize("mode", ["dense", "hash"])
def test_over_budget_sieve_falls_back(monkeypatch, mode):
    # sieve tables past the budget (patched to 0 in both packages): AUTO
    # takes the lockstep walker, PALLAS raises, as in the reference
    monkeypatch.setattr(sieve_matcher, "_VMEM_TABLE_BUDGET", 0)
    monkeypatch.setattr(ref_pallas, "_VMEM_TABLE_BUDGET", 0)
    _lockstep_equal({}, mode)
    for pkg in (pt, pfac_tpu):
        with pytest.raises(pkg.PfacError, match="bytes"):
            kw = {"device": "cpu"} if pkg is pt else {}
            pkg.Matcher(README, backend="pallas", **kw).match(b"ABEDEDABG")


def test_try_build_catches_only_host_table_errors(monkeypatch):
    a = pt.Automaton.from_patterns(README)
    kw = dict(placement=pt.PlacementMode.AUTO, tile=None, device="cpu")
    assert isinstance(select.try_build(a, "dense", required=False, **kw),
                      SieveMatcher)
    assert select.try_build(
        a, "dense", required=False,
        **{**kw, "placement": pt.PlacementMode.HBM}) is None

    def no_convergence(automaton):
        raise ValueError("CHD displacement search did not converge")

    # an error while the host tables are built: the walker serves the call
    # unless the sieve engine is required
    with monkeypatch.context() as mp:
        mp.setattr(sieve_matcher.SieveTables, "build",
                   staticmethod(no_convergence))
        assert select.try_build(a, "dense", required=False, **kw) is None
        with pytest.raises(ValueError, match="converge"):
            select.try_build(a, "dense", required=True, **kw)
        m = pt.Matcher(README, device="cpu")
        assert isinstance(m._engine(), XlaMatcher)
        assert m.match(b"ABEDEDABG").tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]

    # an error from the device (placing the tables, loading or launching a
    # kernel) is never caught
    def device_error(self, device):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(sieve_matcher.SieveTables, "to_device", device_error)
    with pytest.raises(RuntimeError, match="CUDA error"):
        select.try_build(a, "dense", required=False, **kw)
    with pytest.raises(RuntimeError, match="CUDA error"):
        pt.Matcher(README, device="cpu").match(b"ABEDEDABG")


@pytest.mark.parametrize("platform", ["cpu", "cpu_parallel"])
def test_cpu_platforms_need_no_gpu(platform):
    # the default device is "cuda"; a CPU platform never touches it
    m = pt.Matcher(README, platform=platform)
    assert m.match(b"ABEDEDABG").tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]
    ids, pos, n = m.match_reduce(b"ABEDEDABG")
    assert (n, pos.tolist(), ids.tolist()) == (5, [0, 1, 2, 4, 6],
                                               [1, 3, 4, 4, 2])
    out = m.match_device(torch.from_numpy(
        np.frombuffer(b"ABEDEDABG", np.uint8).copy()))
    assert out.device.type == "cpu" and out[:9].tolist() == [
        1, 3, 4, 0, 4, 0, 2, 0, 0]


def test_cuda_requested_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(pt.PfacError, match="CUDA"):
        pt.Matcher(README)

"""The CUDA kernels against their plain torch versions and the golden model,
on the card (bit-exact, tolerance 0). Marked ``cuda``: they skip where
``torch.cuda.is_available()`` is false. This file imports no JAX, so the
card's host runs it without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

import pfac_tpu_torch as pt
from pfac_tpu.backends import golden
from pfac_tpu_torch.backends import (block_walk, csr_walk, pipeline, sieve,
                                     sieve_matcher, walk)
from pfac_tpu_torch.backends.sieve_matcher import npad_for
from pfac_tpu_torch.experiments import (align_micro, axis0_gather_probe,
                                        dyngather_micro, gather_micro,
                                        gathers, harness, lanegather2_micro,
                                        lanegather_micro)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _ruleset(seed: int, k: int = 300):
    rng = np.random.default_rng(seed)
    pats = [bytes(rng.integers(0, 256, size=int(np.clip(rng.gamma(2.2, 9.0) + 1,
                                                         1, 120)),
                               dtype=np.uint8))
            for _ in range(k)]
    return list(dict.fromkeys(pats)), rng


def _corpus(rng, pats, n: int) -> np.ndarray:
    data = rng.integers(0, 256, size=n, dtype=np.uint8)
    for off in rng.integers(0, n - 130, size=n // 200):
        p = pats[int(rng.integers(0, len(pats)))]
        data[off:off + len(p)] = np.frombuffer(p, np.uint8)
    return data


@pytest.mark.parametrize("n", [1, 5, 1023, 65536, 65537, 300001])
def test_kernels_match_plain(dev, n):
    pats, rng = _ruleset(n)
    m = pt.Matcher(pats, device=dev)
    eng = m._engine()
    host = _corpus(rng, pats, max(n, 200))[:n]
    data = torch.from_numpy(host).to(dev)
    npad = npad_for(n)
    mk, fk, ck = sieve.sieve(data, n, npad, eng._sieve)
    mp, fp, cp = sieve.sieve_plain(data, n, npad, eng._sieve)
    assert torch.equal(mk, mp) and torch.equal(fk, fp) and torch.equal(ck, cp)
    pos = sieve.compact(fk)
    out_k, out_p = mk.clone(), mk.clone()
    walk.walk(data, n, pos, out_k, eng._walk)
    walk.walk_plain(data, n, pos, out_p, eng._walk)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p)
    res = m.match_device(data)
    assert torch.equal(res, pipeline.run(data, n, npad, eng._sieve,
                                         eng._walk, plain=True))
    assert res.cpu().numpy()[:n].tolist() == golden.match_edges_batch(
        m.automaton, host).tolist()


def test_conformance_on_card(dev):
    m = pt.Matcher([b"AB", b"ABG", b"BEDE", b"ED"], device=dev)
    assert m.match(b"ABEDEDABG").tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]
    ids, pos, n = m.match_reduce(b"ABEDEDABG")
    assert (n, pos.tolist(), ids.tolist()) == (5, [0, 1, 2, 4, 6],
                                               [1, 3, 4, 4, 2])


def test_launch_counters(dev):
    pats, rng = _ruleset(7)
    m = pt.Matcher(pats, device=dev)
    data = torch.from_numpy(_corpus(rng, pats, 1 << 20)).to(dev)
    sieve.LAUNCHES = walk.LAUNCHES = block_walk.LAUNCHES = 0
    m.match_device(data)
    assert sieve.LAUNCHES == 1 and walk.LAUNCHES == 1
    assert block_walk.LAUNCHES == 1      # armed: one launch, no dense block


def test_unaligned_view(dev):
    # a data view at an odd offset: the sieve copies it to aligned storage
    pats, rng = _ruleset(8)
    host = _corpus(rng, pats, 10001)
    data = torch.from_numpy(host).to(dev)[1:]
    m = pt.Matcher(pats, device=dev)
    got = m.match_device(data).cpu().numpy()[:10000]
    assert got.tolist() == golden.match_edges_batch(m.automaton,
                                                    host[1:]).tolist()


def _dense_corpus(n: int) -> np.ndarray:
    """Blocks of 'a' runs (dense for b"aaaa") between random blocks; n may
    end mid-block."""
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, size=n, dtype=np.uint8)
    for b0 in range(0, n, 3 * 65536):
        data[b0:b0 + 65536] = ord("a")
    data[n // 2:n // 2 + 100] = np.frombuffer(b"aaaab" * 20, np.uint8)
    return data


@pytest.mark.parametrize("n", [65536, 200_000, 3 * 65536 + 777])
def test_block_walk_matches_plain(dev, n):
    pats = [b"aaaa", b"aaaab", b"a" * 40, b"ab", b"a", b"aaab" * 5]
    m = pt.Matcher(pats, device=dev)
    eng = m._engine()
    host = _dense_corpus(n)
    data = torch.from_numpy(host).to(dev)
    npad = npad_for(n)
    match, flags, counts = sieve.sieve(data, n, npad, eng._sieve)
    assert block_walk.escaped_blocks(counts, npad) >= 1
    mk, fk = match.clone(), flags.clone()
    block_walk.block_walk(data, n, counts, mk, fk, eng._walk)
    block_walk.block_walk_plain(data, n, counts, match, flags, eng._walk)
    torch.cuda.synchronize()
    assert torch.equal(mk, match) and torch.equal(fk, flags)
    res = m.match_device(data)
    assert torch.equal(res, pipeline.run(data, n, npad, eng._sieve, eng._walk,
                                         plain=True))
    assert torch.equal(res, pipeline.run(data, n, npad, eng._sieve, eng._walk,
                                         escape=False))
    assert res.cpu().numpy()[:n].tolist() == golden.match_edges_batch(
        m.automaton, host).tolist()


def _csr_ruleset():
    rng = np.random.default_rng(1)
    return [bytes(rng.integers(0, 256, size=int(k), dtype=np.uint8))
            for k in rng.integers(60, 120, size=3000)], rng


@pytest.mark.parametrize("n", [5, 65536, 300_001])
def test_csr_tier_on_card(dev, n):
    # walk tables past their budget: the CSR tier, n ending mid-block
    pats, rng = _csr_ruleset()
    m = pt.Matcher(pats, device=dev)
    eng = m._engine()
    assert eng.walk_tables is None and eng.csr_tables is not None
    host = _corpus(rng, pats, max(n, 200))[:n]
    data = torch.from_numpy(host).to(dev)
    npad = npad_for(n)
    match, flags, _ = sieve.sieve(data, n, npad, eng._sieve)
    pos = sieve.compact(flags)
    out_k, out_p = match.clone(), match.clone()
    csr_walk.csr_walk(data, n, pos, out_k, eng._csr)
    csr_walk.csr_walk_plain(data, n, pos, out_p, eng._csr)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p)
    sieve.LAUNCHES = csr_walk.LAUNCHES = block_walk.LAUNCHES = 0
    res = m.match_device(data)
    assert sieve.LAUNCHES == 1 and block_walk.LAUNCHES == 0
    assert csr_walk.LAUNCHES == (1 if pos.numel() else 0)
    assert torch.equal(res, pipeline.run(data, n, npad, eng._sieve, None,
                                         eng._csr, plain=True))
    assert res.cpu().numpy()[:n].tolist() == golden.match_edges_batch(
        m.automaton, host).tolist()


def test_forced_csr_tier_on_card(dev, monkeypatch):
    # a Snort-like ruleset through the CSR tier: its deep matches equal the
    # walk-table tier's
    pats, rng = _ruleset(11)
    host = _corpus(rng, pats, 1 << 20)
    data = torch.from_numpy(host).to(dev)
    walk_res = pt.Matcher(pats, device=dev).match_device(data)
    monkeypatch.setattr(sieve_matcher, "build_walk_tables_gated",
                        lambda *a: None)
    m = pt.Matcher(pats, device=dev)
    assert m._engine().csr_tables is not None
    assert torch.equal(m.match_device(data), walk_res)


def _words(dev, w: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=w,
                                          dtype=np.int64).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, w, size=n).astype(np.int32))
    return table.to(dev), idx.to(dev)


@pytest.mark.parametrize("placement", gathers.PLACEMENTS)
@pytest.mark.parametrize("w,n", [(1, 1), (3200, 1000), (58112, 70001),
                                 (4096, 1 << 22)])
def test_word_gather_on_card(dev, placement, w, n):
    table, idx = _words(dev, w, n, w + n)
    gathers.LAUNCHES["word_gather_kernel"] = 0
    got = gathers.word_gather(table, idx, placement)
    assert gathers.LAUNCHES["word_gather_kernel"] == 1
    assert torch.equal(got, gathers.word_gather_plain(table, idx))


@pytest.mark.parametrize("placement", ["ldg", "cg"])
@pytest.mark.parametrize("w", [66560, 147712, 10_000_000])
def test_word_gather_large_tables_on_card(dev, placement, w):
    table, idx = _words(dev, w, 300_001, w)
    assert torch.equal(gathers.word_gather(table, idx, placement),
                       gathers.word_gather_plain(table, idx))


def test_smem_limit_on_card(dev):
    table, idx = _words(dev, gathers.SMEM_WORDS, 5000, 1)
    assert torch.equal(gathers.word_gather(table, idx, "smem"), table[idx.long()])
    assert torch.equal(gathers.chain_gather(table, idx, 2, "smem", True),
                       gathers.chain_gather_plain(table, idx, 2, True))
    big, _ = _words(dev, gathers.SMEM_WORDS + 1, 1, 2)
    with pytest.raises(ValueError, match="shared memory"):
        gathers.word_gather(big, idx, "smem")
    with pytest.raises(ValueError, match="shared memory"):
        gathers.chain_gather(big, idx, 1, "smem")


@pytest.mark.parametrize("placement", gathers.PLACEMENTS)
@pytest.mark.parametrize("chain", [1, 4])
@pytest.mark.parametrize("hashed", [False, True])
@pytest.mark.parametrize("w", [264, 16384, 58112])
def test_chain_gather_on_card(dev, placement, chain, hashed, w):
    rng = np.random.default_rng(w + chain)
    table = torch.from_numpy(rng.integers(0, w, size=w).astype(np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, w, size=100_003).astype(np.int32)
                           ).to(dev)
    got = gathers.chain_gather(table, idx, chain, placement, hashed)
    assert torch.equal(got, gathers.chain_gather_plain(table, idx, chain,
                                                       hashed))


@pytest.mark.parametrize("rows,cols,m,k,axis", [
    (8, 128, 8, 128, 1), (8, 128, 131072, 128, 1), (8, 100, 24, 37, 1),
    (512, 128, 8, 128, 0), (512, 128, 512, 128, 0), (32, 128, 8, 128, 0),
    (1816, 40, 3001, 40, 0)])
def test_tile_gather_on_card(dev, rows, cols, m, k, axis):
    rng = np.random.default_rng(rows + m)
    tile = torch.from_numpy(rng.integers(0, 1 << 30, size=(rows, cols))
                            .astype(np.int32)).to(dev)
    hi = rows if axis == 0 else cols
    idx = torch.from_numpy(rng.integers(0, hi, size=(m, k)).astype(np.int32)
                           ).to(dev)
    assert torch.equal(gathers.tile_gather(tile, idx, axis),
                       gathers.tile_gather_plain(tile, idx, axis))


@pytest.mark.parametrize("groups,w_out,w_raw", [(1, 26, 64), (64, 26, 64),
                                                (3, 1, 32), (5, 33, 64)])
def test_align_on_card(dev, groups, w_out, w_raw):
    rng = np.random.default_rng(groups)
    pos = torch.from_numpy(rng.integers(0, 1 << 26, size=(groups * 8, 128))
                           .astype(np.int32)).to(dev)
    raw = torch.from_numpy(rng.integers(0, 1 << 30,
                                        size=(groups * w_raw * 8, 128))
                           .astype(np.int32)).to(dev)
    assert torch.equal(gathers.align(pos, raw, w_out),
                       gathers.align_plain(pos, raw, w_out))


@pytest.mark.parametrize("make", [
    lambda d: lanegather_micro.cases(d, n_idx=1 << 16),
    lambda d: gather_micro.cases(d, big=1 << 16),
    lambda d: dyngather_micro.cases(d, n_idx=1 << 16),
    lambda d: align_micro.cases(d, survivors=4096),
    axis0_gather_probe.cases,
    lambda d: lanegather2_micro.cases(d, n_idx=1 << 16)],
    ids=["E1", "E2", "E3", "E4", "E5", "E6"])
def test_micro_benchmark_cases_on_card(dev, make):
    for k in gathers.LAUNCHES:
        gathers.LAUNCHES[k] = 0
    for item in make(dev):
        if isinstance(item, harness.Refusal):
            harness.refuse(item)
        else:
            assert harness.check(item) == 0
    assert sum(gathers.LAUNCHES.values()) > 0

"""The CUDA kernels against their plain torch versions and the golden model,
on the card (bit-exact, tolerance 0). Marked ``cuda``: they skip where
``torch.cuda.is_available()`` is false. This file imports neither JAX nor
the reference package, so the card's host runs it without the repo's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import json

import numpy as np
import pytest
import torch

import pfac_tpu_torch as pt
from pfac_tpu_torch.backends import (block_walk, compact, csr_walk, golden,
                                     pipeline, sieve, sieve_matcher, walk)
from pfac_tpu_torch.backends.sieve_matcher import npad_for
from pfac_tpu_torch.tools import bench, bench_matrix, graft_entry
from pfac_tpu_torch.experiments import (align_micro, axis0_gather_probe,
                                        dyngather_micro, gather_micro,
                                        gathers, harness, lanegather2_micro,
                                        lanegather_micro, rulesets)

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
    mk, bk, ck = sieve.sieve(data, n, npad, eng._sieve)
    mp, bp, cp = sieve.sieve_plain(data, n, npad, eng._sieve)
    assert torch.equal(mk, mp) and torch.equal(bk, bp) and torch.equal(ck, cp)
    pos, count = compact.compact(bk, ck, sieve.BLOCK + 1)
    exact = compact.compact_plain(bp, cp, sieve.BLOCK + 1)
    assert torch.equal(pos[:int(count)], exact)
    out_k, out_p = mk.clone(), mk.clone()
    walk.walk(data, n, pos, out_k, eng._walk, count)
    walk.walk_plain(data, n, exact, out_p, eng._walk)
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
    _zero(sieve.LAUNCHES, compact.LAUNCHES)
    walk.LAUNCHES = block_walk.LAUNCHES = 0
    m.match_device(data)
    assert sum(sieve.LAUNCHES.values()) == 1 and walk.LAUNCHES == 1
    assert sieve.LAUNCHES["sieve_smem_kernel"] == 1
    assert compact.LAUNCHES == {"compact_scan_kernel": 1, "compact_kernel": 1}
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


@pytest.mark.parametrize("block", [65536, 8192])
@pytest.mark.parametrize("n", [65536, 200_000, 3 * 65536 + 777,
                               3 * 65536 + 3 * 8192 + 3])
def test_block_walk_matches_plain(dev, n, block):
    pats = [b"aaaa", b"aaaab", b"a" * 40, b"ab", b"a", b"aaab" * 5]
    m = pt.Matcher(pats, device=dev, tile=block)
    eng = m._engine()
    assert eng.tile_rows * 128 == block
    host = _dense_corpus(n)
    data = torch.from_numpy(host).to(dev)
    npad = npad_for(n, eng.tile_rows)
    match, bits, counts = sieve.sieve(data, n, npad, eng._sieve, block)
    assert block_walk.escaped_blocks(counts, npad) >= 1
    mk, mt = match.clone(), match.clone()
    block_walk.block_walk(data, n, counts, mk, eng._walk)
    block_walk.block_walk_tiles_plain(data, n, counts, mt, eng._walk)
    block_walk.block_walk_plain(data, n, counts, match, eng._walk)
    torch.cuda.synchronize()
    assert torch.equal(mk, match) and torch.equal(mt, match)
    thresh = block // block_walk.DENSE_ESCAPE_DIV
    pos, count = compact.compact(bits, counts, thresh)
    assert torch.equal(pos[:int(count)],
                       compact.compact_plain(bits, counts, thresh))
    res = m.match_device(data)
    assert torch.equal(res, pipeline.run(data, n, npad, eng._sieve, eng._walk,
                                         block=block, plain=True))
    assert torch.equal(res, pipeline.run(data, n, npad, eng._sieve, eng._walk,
                                         block=block, escape=False))
    assert res.cpu().numpy()[:n].tolist() == golden.match_edges_batch(
        m.automaton, host).tolist()


def _k3_equal(data, n, eng, block=sieve.BLOCK):
    """K3 on the card against its plain version; -> (blocks escaped, K3's
    result)."""
    npad = npad_for(n, block // 128)
    match, _, counts = sieve.sieve(data, n, npad, eng._sieve, block)
    mk = match.clone()
    block_walk.block_walk(data, n, counts, mk, eng._walk)
    block_walk.block_walk_plain(data, n, counts, match, eng._walk)
    torch.cuda.synchronize()
    assert torch.equal(mk, match)
    return block_walk.escaped_blocks(counts, npad), mk


def test_block_walk_tables_beyond_resident(dev):
    # the Snort-scale walk arena does not fit beside the tile buffers: deep
    # steps are read through L1/L2, shallow ones from shared memory
    pats = rulesets.snort_like_patterns() + [b"zzzz", b"zzzzzzzz"]
    m = pt.Matcher(pats, device=dev)
    eng = m._engine()
    nsteps = block_walk.steps_of(eng._walk)
    budget = sieve.SMEM_LIMIT - block_walk.fixed_smem_bytes(nsteps, 4)
    assert 0 < block_walk.resident_words(eng._walk, budget) \
        < eng._walk.arena.numel()
    n = (4 << 20) + 12345
    host = rulesets.mixed_density(np.random.default_rng(5), pats, n,
                                  sieve.BLOCK)
    # deep matches inside a dense block: long patterns planted among the z
    deep = [p for p in pats if len(p) > 60][:20]
    for i, p in enumerate(deep):
        off = sieve.BLOCK + 1000 + 400 * i
        host[off:off + len(p)] = np.frombuffer(p, np.uint8)
    data = torch.from_numpy(host).to(dev)
    esc, _ = _k3_equal(data, n, eng)
    assert esc >= 4
    res = m.match_device(data)
    assert res.cpu().numpy()[:n].tolist() == golden.match_edges_batch(
        m.automaton, host).tolist()


def test_block_walk_no_dense_block(dev):
    pats, rng = _ruleset(5)
    m = pt.Matcher(pats, device=dev)
    eng = m._engine()
    n = 1 << 20
    data = torch.from_numpy(_corpus(rng, pats, n)).to(dev)
    match, _, counts = sieve.sieve(data, n, npad_for(n), eng._sieve)
    assert block_walk.escaped_blocks(counts, npad_for(n)) == 0
    before = match.clone()
    block_walk.LAUNCHES = 0
    block_walk.block_walk(data, n, counts, match, eng._walk)
    torch.cuda.synchronize()
    assert block_walk.LAUNCHES == 1 and torch.equal(match, before)


@pytest.mark.parametrize("offset", [1, 3, 4, 13, 16])
def test_block_walk_unaligned_view(dev, offset):
    # the bulk copy's source is aligned down; the first tile of a
    # misaligned view and the tiles next to n are copied by the threads
    pats = [b"aaaa", b"aaaab", b"a" * 40, b"ab", b"a", b"aaab" * 5]
    eng = pt.Matcher(pats, device=dev)._engine()
    n = 3 * 65536 + 777
    data = torch.from_numpy(_dense_corpus(n + 64)).to(dev)[offset:]
    assert data.data_ptr() % 16 == offset % 16
    esc, _ = _k3_equal(data, n, eng)
    assert esc >= 1


def test_block_walk_long_patterns(dev):
    # matches of ~1 KB that run hundreds of bytes into the next tile and the
    # next block: the lookahead follows the walk's depth
    pats = [b"z" * 1000 + b"y", b"zzzz", b"z" * 600 + b"y"]
    m = pt.Matcher(pats, device=dev)
    eng = m._engine()
    assert block_walk.lookahead(block_walk.steps_of(eng._walk)) >= 1001
    d = bytearray(b"z" * (sieve.BLOCK + 500) + b"y" + bytes(3000))
    d[40000:40001] = b"y"
    host = np.frombuffer(bytes(d), np.uint8)
    data = torch.from_numpy(host.copy()).to(dev)
    esc, got = _k3_equal(data, len(d), eng)
    assert esc == 1
    got = got.cpu().numpy()
    assert got[39000] == 1 and got[39400] == 3 and got[39001] == 2
    assert got[sieve.BLOCK - 500] == 1 and got[sieve.BLOCK - 100] == 3
    assert m.match_device(data).cpu().numpy()[:len(d)].tolist() == \
        golden.match_edges_batch(m.automaton, host).tolist()


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
    match, bits, counts = sieve.sieve(data, n, npad, eng._sieve)
    pos, count = compact.compact(bits, counts, sieve.BLOCK + 1)
    out_k, out_p = match.clone(), match.clone()
    csr_walk.csr_walk(data, n, pos, out_k, eng._csr, count)
    csr_walk.csr_walk_plain(data, n, pos, out_p, eng._csr, count)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p)
    _zero(sieve.LAUNCHES)
    csr_walk.LAUNCHES = block_walk.LAUNCHES = 0
    res = m.match_device(data)
    assert sum(sieve.LAUNCHES.values()) == 1 and block_walk.LAUNCHES == 0
    assert csr_walk.LAUNCHES == 1          # whatever the survivor count
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


def _zero(*counts: dict) -> None:
    for c in counts:
        for k in c:
            c[k] = 0


@pytest.mark.parametrize("placement", sieve.PLACEMENTS)
@pytest.mark.parametrize("n", [5, 65536, 300_001, 3 << 20])
def test_sieve_placements_match_plain(dev, placement, n):
    # every placement, forced, on a walk-tier and a CSR-tier ruleset
    for pats, rng in (_ruleset(n + 1), _csr_ruleset()):
        tabs = pt.Matcher(pats, device=dev)._engine()._sieve
        host = _corpus(rng, pats, max(n, 200))[:n]
        data = torch.from_numpy(host).to(dev)
        npad = npad_for(n)
        _zero(sieve.LAUNCHES)
        got = sieve.sieve(data, n, npad, tabs, placement=placement)
        assert sieve.LAUNCHES[f"sieve_{placement}_kernel"] == 1
        want = sieve.sieve_plain(data, n, npad, tabs)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_sieve_placement_rule(dev):
    small = pt.Matcher(_ruleset(3)[0], device=dev)._engine()._sieve
    assert sieve.placement_for(small) == "smem"
    # 100,000 distinct 4-byte prefixes: 2^17 residual slots, 256 KiB packed
    big = sieve_matcher.SieveTables.build(pt.Automaton.from_patterns(
        [bytes([i >> 16, (i >> 8) & 255, i & 255, 7, 9])
         for i in range(100_000)])).to_device(dev)
    assert sieve.placement_for(big) == "cluster"
    with pytest.raises(ValueError, match="shared memory"):
        sieve.sieve(torch.zeros(8192, dtype=torch.uint8, device=dev), 8192,
                    65536, big, placement="smem")


@pytest.mark.parametrize("density", [0.0, 1e-4, 0.01, 0.3, 1.0])
@pytest.mark.parametrize("block", [8192, 65536])
def test_compact_kernel_matches_plain(dev, density, block):
    rng = np.random.default_rng(int(density * 1e4) + block)
    npad = 37 * block
    flags = torch.from_numpy((rng.random(npad) < density).astype(np.uint8))
    if density < 1.0:
        flags[5 * block:6 * block] = 1          # one dense block
    flags[-1] = 1                       # the last word of the last block
    flags = flags.to(dev)
    bits = sieve.pack_bits(flags)
    counts = flags.view(-1, block).sum(1, dtype=torch.int32)
    for thresh in (block // 4, block + 1, 1):
        _zero(compact.LAUNCHES)
        got, count = compact.compact(bits, counts, thresh)
        assert compact.LAUNCHES == {"compact_scan_kernel": 1,
                                    "compact_kernel": 1}
        assert got.numel() == compact.capacity(counts.numel(), block, thresh)
        assert torch.equal(got[:int(count)],
                           compact.compact_plain(bits, counts, thresh))


def _count_cases(dev, pos: torch.Tensor):
    """(name, buffer, count) cases of the walkers' contract: the buffer
    whole, a buffer longer than the count whose words past it are
    positions < n that would match (they must not be walked), and a count
    of 0."""
    half = pos.numel() // 2
    assert half > 0
    one = lambda k: torch.tensor([k], dtype=torch.int32, device=dev)
    return [("whole", pos, None), ("past the count", pos, one(half)),
            ("count 0", pos, one(0))]


@pytest.mark.parametrize("offset", [0, 3])
def test_walkers_count_contract(dev, offset):
    # K2 and the CSR walk on the card against their plain versions on the
    # exact positions, from a data view at `offset`
    for pats, rng in (_ruleset(21), _csr_ruleset()):
        eng = pt.Matcher(pats, device=dev)._engine()
        n = 300_001
        host = _corpus(rng, pats, n + offset)
        data = torch.from_numpy(host).to(dev)[offset:]
        match, bits, counts = sieve.sieve(data, n, npad_for(n), eng._sieve)
        pos, count = compact.compact(bits, counts, sieve.BLOCK + 1)
        pos = pos[:int(count)].flip(0).contiguous()   # any order
        fn = walk if eng._walk is not None else csr_walk
        run, plain = ((walk.walk, walk.walk_plain) if fn is walk
                      else (csr_walk.csr_walk, csr_walk.csr_walk_plain))
        tabs = eng._walk if fn is walk else eng._csr
        for name, buf, cnt in _count_cases(dev, pos):
            fn.LAUNCHES = 0
            out_k, out_p = match.clone(), match.clone()
            run(data, n, buf, out_k, tabs, cnt)
            k = buf.numel() if cnt is None else int(cnt)
            plain(data, n, buf[:k].clone(), out_p, tabs)
            torch.cuda.synchronize()
            assert fn.LAUNCHES == 1, name
            assert torch.equal(out_k, out_p), name
            assert (k == 0) == torch.equal(out_k, match), name


@pytest.mark.parametrize("which", ["none", "entry", "plan", "all"])
def test_walk_resident_prefixes(dev, which, monkeypatch):
    # K2 with none, the entry tables, the plan's prefix and the whole arena
    # in shared memory (the Snort arena does not fit whole: a small one)
    pats = (_ruleset(4)[0] if which == "all"
            else rulesets.snort_like_patterns())
    eng = pt.Matcher(pats, device=dev)._engine()
    tabs = eng._walk
    nsteps, planned = walk.launch_plan(tabs, dev)
    words = tabs.arena.numel()
    resident = {"none": 0, "entry": walk.table_ends(tabs)[1],
                "plan": planned, "all": words}[which]
    assert (planned == words) == (which == "all")
    assert which != "plan" or 0 < planned < words
    monkeypatch.setattr(walk, "launch_plan", lambda t, d: (nsteps, resident))
    rng = np.random.default_rng(8)
    n = 4 << 20
    data = torch.from_numpy(rulesets.planted_text(rng, pats, n, 0.5)).to(dev)
    match, bits, counts = sieve.sieve(data, n, npad_for(n), eng._sieve)
    exact = compact.compact_plain(bits, counts, sieve.BLOCK + 1)
    # enough survivors that every CTA stages its prefix (kStageMin = 256 a
    # CTA in csrc/walk.cu; fewer are walked from L1/L2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert exact.numel() >= 256 * sms
    out_k, out_p = match.clone(), match.clone()
    walk.walk(data, n, exact, out_k, tabs)
    walk.walk_plain(data, n, exact, out_p, tabs)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p) and not torch.equal(out_k, match)


def _f1_patterns():
    """ROADMAP.md's F1 ruleset (17,000 random 6-byte patterns, seed 17000)
    and zzzz, zzzzzzzz for a dense block: its entry tables do not fit the
    walk kernels' shared memory."""
    rng = np.random.default_rng(17000)
    return [bytes(rng.integers(0, 256, size=6, dtype=np.uint8))
            for _ in range(17000)] + [b"zzzz", b"zzzzzzzz"]


def test_f1_entry_tables_beyond_shared_memory(dev):
    pats = _f1_patterns()
    m = pt.Matcher(pats, device=dev)
    eng = m._engine()
    n = (3 << 20) + 777
    host = rulesets.mixed_density(np.random.default_rng(17), pats, n,
                                  sieve.BLOCK)
    data = torch.from_numpy(host).to(dev)
    npad = npad_for(n)
    assert walk.launch_plan(eng._walk, dev)[1] == 0
    assert block_walk.launch_plan(eng._walk, npad // block_walk.CHUNK,
                                  dev)[3] == 0
    esc, _ = _k3_equal(data, n, eng)
    assert esc >= 1
    res = m.match_device(data)
    assert torch.equal(res, pipeline.run(data, n, npad, eng._sieve, eng._walk,
                                         plain=True))
    assert res.cpu().numpy()[:n].tolist() == golden.match_edges_batch(
        m.automaton, host).tolist()


def test_block_walk_resident_zero(dev, monkeypatch):
    # K3 with nothing of the arena in shared memory: no bulk copy, no wait
    pats = rulesets.snort_like_patterns() + [b"zzzz", b"zzzzzzzz"]
    eng = pt.Matcher(pats, device=dev)._engine()
    real = block_walk.launch_plan
    monkeypatch.setattr(block_walk, "launch_plan",
                        lambda *a: real(*a)[:3] + (0,))
    n = (2 << 20) + 5
    host = rulesets.mixed_density(np.random.default_rng(9), pats, n,
                                  sieve.BLOCK)
    esc, _ = _k3_equal(torch.from_numpy(host).to(dev), n, eng)
    assert esc >= 1


def test_match_device_does_not_synchronize(dev):
    # no host round trip on either tier: a synchronising call raises
    cases = [(_ruleset(31), 4 << 20), (_csr_ruleset(), 4 << 20)]
    for (pats, rng), n in cases:
        m = pt.Matcher(pats, device=dev)
        data = torch.from_numpy(_corpus(rng, pats, n)).to(dev)
        want = m.match_device(data)             # warm: tables, plans, cache
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = m.match_device(data)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(got, want)


def _words(dev, w: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=w,
                                          dtype=np.int64).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, w, size=n).astype(np.int32))
    return table.to(dev), idx.to(dev)


@pytest.mark.parametrize("placement", [*gathers.PLACEMENTS, None])
@pytest.mark.parametrize("w,n", [(1, 1), (3200, 1000), (58112, 70001),
                                 (4096, 1 << 22), (4096, (1 << 20) + 3)])
def test_word_gather_on_card(dev, placement, w, n):
    # every placement and the default one; a ragged tail of 3 lookups
    table, idx = _words(dev, w, n, w + n)
    for k in gathers.LAUNCHES:
        gathers.LAUNCHES[k] = 0
    got = gathers.word_gather(table, idx, placement)
    assert gathers.LAUNCHES[gathers.word_kernel(w, placement, n)] == 1
    assert sum(gathers.LAUNCHES.values()) == 1
    assert torch.equal(got, gathers.word_gather_plain(table, idx))


@pytest.mark.parametrize("placement", gathers.PLACEMENTS)
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_word_gather_unaligned_on_card(dev, placement, offset):
    # index and output streams not 16-byte aligned take the word path
    table, idx = _words(dev, 4096, 100_003, offset)
    view = idx[offset:]
    assert torch.equal(gathers.word_gather(table, view, placement),
                       gathers.word_gather_plain(table, view))


@pytest.mark.parametrize("placement", ["cluster", "prefix", None])
@pytest.mark.parametrize("w", [
    2176,                       # the Snort sieve arena (8,704 B)
    65208,                      # the Snort walk arena (260,832 B)
    66560,                      # E2's pair table
    82176,                      # the 100K sieve arena (328,704 B)
    2 * gathers.SMEM_WORDS + 1,  # the first table of a 4-CTA cluster
    gathers.CLUSTER_WORDS])
def test_word_gather_cluster_on_card(dev, placement, w):
    # the tables past one CTA's shared memory that a cluster holds, in the
    # cluster, as a shared-memory prefix, and in the default placement
    table, idx = _words(dev, w, (1 << 20) + 1, w + 7)
    if placement is None:
        assert gathers.word_placement(w) == ("smem" if w <= gathers.SMEM_WORDS
                                             else "prefix")
    for k in gathers.LAUNCHES:
        gathers.LAUNCHES[k] = 0
    got = gathers.word_gather(table, idx, placement)
    kernel = gathers.word_kernel(w, placement, idx.numel())
    assert gathers.LAUNCHES[kernel] == 1
    assert sum(gathers.LAUNCHES.values()) == 1
    assert torch.equal(got, gathers.word_gather_plain(table, idx))
    assert torch.equal(got, gathers.word_gather_cluster_plain(table, idx))


@pytest.mark.parametrize("placement", ["ldg", "cg", "prefix", None])
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


@pytest.mark.parametrize("placement", gathers.CHAIN_PLACEMENTS)
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
    (1816, 40, 3001, 40, 0),
    # the rule's edge, the most lookups of the direct path and one row more
    (8, 128, 16, 128, 1), (32, 128, 9, 128, 0), (8, 100, 8, 100, 1),
    (8, 100, 16, 100, 1), (50, 40, 40, 40, 0), (50, 40, 41, 40, 0)])
def test_tile_gather_on_card(dev, rows, cols, m, k, axis):
    rng = np.random.default_rng(rows + m)
    tile = torch.from_numpy(rng.integers(0, 1 << 30, size=(rows, cols))
                            .astype(np.int32)).to(dev)
    hi = rows if axis == 0 else cols
    idx = torch.from_numpy(rng.integers(0, hi, size=(m, k)).astype(np.int32)
                           ).to(dev)
    want = gathers.tile_gather_plain(tile, idx, axis)
    rule = gathers.tile_path(rows, cols, m, k, axis)
    for path, kernel in ((None, None), ("direct", "tile_gather_direct_kernel"),
                         ("staged", "tile_gather_kernel")):
        kernel = kernel or ("tile_gather_direct_kernel" if rule == "direct"
                            else "tile_gather_kernel")
        gathers.LAUNCHES[kernel] = 0
        assert torch.equal(gathers.tile_gather(tile, idx, axis, path), want)
        assert gathers.LAUNCHES[kernel] == 1


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


@pytest.mark.parametrize("mode", ["dense", "hash"])
@pytest.mark.parametrize("n", [1, 1000, 131_073, 600_001])
def test_lockstep_walker_on_card(dev, mode, n):
    # the lockstep walker on the card equals itself on the CPU, the sieve
    # engine on the card and the golden model
    from pfac_tpu_torch.backends.xla import XlaMatcher
    pats, rng = _ruleset(n + 17)
    a = pt.Automaton.from_patterns(pats)
    host = _corpus(rng, pats, max(n, 200))[:n]
    data = torch.from_numpy(host).to(dev)
    on_card = XlaMatcher(a, perf_mode=mode, device=dev).match_device(data)
    on_cpu = XlaMatcher(a, perf_mode=mode).match_device(data.cpu())
    assert torch.equal(on_card.cpu(), on_cpu)
    sieve_res = pt.Matcher(automaton=a, device=dev).match_device(data)
    assert torch.equal(on_card[:n], sieve_res[:n])
    assert on_cpu[:n].tolist() == golden.match_edges_batch(a, host).tolist()
    m = pt.Matcher(automaton=a, device=dev, backend="xla", perf_mode=mode)
    assert isinstance(m._engine(), XlaMatcher)
    assert m.match(host.tobytes()).tolist() == on_cpu[:n].tolist()


@pytest.mark.parametrize("npad", [1, 5, 4096, 4097, 3 * 4096 + 77,
                                  65_536 + 96, (1 << 22) + 131_075])
@pytest.mark.parametrize("density", [0.0, 0.03, 1.0])
@pytest.mark.parametrize("offset", [0, 1])
def test_reduce_kernel_matches_plain(dev, npad, density, offset):
    # reduce_kernel and reduce_tail_kernel against the plain reduce: a cut
    # last tile, count 0 and count npad, a result that is a view 4 bytes in
    # (word loads); the ticket is left at 0 for the next call, which runs
    # the same on the status words of the call before
    from pfac_tpu_torch.backends import reduce
    rng = np.random.default_rng(npad)
    res = np.where(rng.random(npad + offset) < density,
                   rng.integers(1, 1 << 20, size=npad + offset),
                   0).astype(np.int32)
    r = torch.from_numpy(res).to(dev)[offset:]
    before = dict(reduce.LAUNCHES)
    want = reduce.reduce_plain(r)
    for _ in range(2):
        ids, pos, count = reduce.reduce_from_dense(r)
        assert count.dim() == 0 and int(count) == int(want[2])
        assert torch.equal(ids, want[0]) and torch.equal(pos, want[1])
        for status, _ in reduce._SCRATCH.values():
            assert int(status[0]) == 0
    assert {k: n - before[k] for k, n in reduce.LAUNCHES.items()} == {
        "reduce_kernel": 2, "reduce_tail_kernel": 2}


def test_reduce_does_not_synchronize(dev):
    # match_reduce_device on both engines under the sync debug mode: the
    # reduce launches reduce_kernel and reduce_tail_kernel and never waits
    # for the device (the lockstep walker's own match_device does, so its
    # result is made first); the sieve engine's compaction runs once
    from pfac_tpu_torch.backends import reduce
    from pfac_tpu_torch.backends.xla import XlaMatcher
    pats, rng = _ruleset(77)
    host = _corpus(rng, pats, 300_001)
    data = torch.from_numpy(host).to(dev)
    m = pt.Matcher(pats, device=dev)
    m.match_reduce_device(data)                   # warm
    xres = XlaMatcher(m.automaton, device=dev).match_device(data)
    torch.cuda.synchronize()
    counts = (reduce.LAUNCHES["reduce_kernel"],
              reduce.LAUNCHES["reduce_tail_kernel"],
              compact.LAUNCHES["compact_kernel"])
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = m.match_reduce_device(data)
        xgot = reduce.reduce_from_dense(xres)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (reduce.LAUNCHES["reduce_kernel"] - counts[0],
            reduce.LAUNCHES["reduce_tail_kernel"] - counts[1],
            compact.LAUNCHES["compact_kernel"] - counts[2]) == (2, 2, 1)
    g_ids, g_pos, g_n = golden.reduce_result(
        golden.match_edges_batch(m.automaton, host))
    for ids, pos, cnt in (got, xgot):
        c = int(cnt)
        assert c == g_n and pos[:c].tolist() == g_pos.tolist()
        assert ids[:c].tolist() == g_ids.tolist()
        assert not ids[c:].any() and not pos[c:].any()


def _sharded(m, dev, k):
    from pfac_tpu_torch.dist.sharding import ShardedMatcher, make_data_mesh
    return ShardedMatcher(m.automaton, mesh=make_data_mesh(devices=[dev] * k),
                          engine=m._engine())


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("tier", ["walk", "csr", "all_match"])
def test_sharded_sieve_equals_single(dev, k, tier):
    # the sieve engine on k shards of one card: the shards' results equal
    # the single device's in full, the count its matching positions, and
    # match_reduce its match_reduce_device, with a pattern across every
    # boundary
    n = 3 << 20
    if tier == "all_match":
        pats, host = [b"aaaa", b"a" * 40], np.full(n, ord("a"), np.uint8)
        host[1000:1010] = ord("b")
    else:
        pats, rng = _ruleset(41) if tier == "walk" else _csr_ruleset()
        host = _corpus(rng, pats, n)
    m = pt.Matcher(pats, device=dev)
    sm = _sharded(m, dev, k)
    assert sm.engine == "sieve"
    sl = sm._shard_len(n)
    longest = max(pats, key=len)
    for b in range(sl, n - len(longest), sl):
        host[b - 1:b - 1 + len(longest)] = np.frombuffer(longest, np.uint8)
    data = torch.from_numpy(host).to(dev)
    single = m.match_device(data)
    res, count = sm.match_device(sm._put(data, sl), n)
    cat = torch.cat(res)
    assert torch.equal(cat[:n], single[:n]) and not cat[n:].any()
    assert int(count) == int((single > 0).sum())
    ids, pos, c = sm.match_reduce(host)
    s_ids, s_pos, s_c = m.match_reduce_device(data)
    assert c == int(s_c) and pos.tolist() == s_pos[:c].tolist()
    assert ids.tolist() == s_ids[:c].tolist()
    want = golden.match_edges_batch(m.automaton, host[:sl + 4096])
    assert np.array_equal(cat[:sl + 4096 - 300].cpu().numpy(),
                          want[:sl + 4096 - 300])


def test_sharded_match_device_does_not_synchronize(dev):
    pats, rng = _ruleset(43)
    m = pt.Matcher(pats, device=dev)
    data = torch.from_numpy(_corpus(rng, pats, 4 << 20)).to(dev)
    sm = _sharded(m, dev, 2)
    shards = sm._put(data, sm._shard_len(data.shape[0]))
    want, cnt = sm.match_device(shards, data.shape[0])     # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, got_cnt = sm.match_device(shards, data.shape[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(got_cnt) == int(cnt)


@pytest.mark.parametrize("n", [1, 5, 70_000])
def test_sharded_shards_past_the_end(dev, n):
    # an input shorter than the mesh: the shards past it launch nothing
    pats, rng = _ruleset(45)
    m = pt.Matcher(pats, device=dev)
    host = _corpus(rng, pats, max(n, 200))[:n]
    sm = _sharded(m, dev, 4)
    assert np.array_equal(sm.match(host),
                          golden.match_edges_batch(m.automaton, host))


def test_bench_on_card(dev, capsys):
    # its gates (conformance, the 4 KB sample, the fingerprint of the whole
    # 16 MB result and its first 4 MB) pass before the line is printed
    assert bench.main(["--mb", "16"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["corpus_mb"] == 16 and rec["slice_bytes"] == 4 << 20
    assert rec["device"] == torch.cuda.get_device_name(0)
    assert rec["power_limit"] and rec["value"] > 0


def test_virus_dense_worst_on_card(dev):
    # the whole 8 MB result equal to the plain pipeline and to
    # match_dense_batch; every survivor goes to K2 (no block escapes)
    (run,) = bench_matrix.prepare(dev, ["virus_dense_worst"])
    bench_matrix.check(run)
    assert bench_matrix.survivors(run) == 396_847
    eng = run.engine
    n = run.data.shape[0]
    _, _, counts = sieve.sieve(run.data, n, npad_for(n), eng._sieve)
    assert block_walk.escaped_blocks(counts, npad_for(n)) == 0


def test_graft_entry_on_card(dev):
    fn, args = graft_entry.entry(dev)
    cpu_fn, cpu_args = graft_entry.entry("cpu")
    assert torch.equal(fn(*args).cpu(), cpu_fn(*cpu_args))
    assert graft_entry.dryrun_multichip(4).startswith(
        "dryrun_multichip(4): OK")

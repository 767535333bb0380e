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
from pfac_tpu_torch import _build, trace
from pfac_tpu_torch.backends import (block_walk, compact, count, csr_walk,
                                     golden, pipeline, program, reduce, sieve,
                                     sieve_matcher, walk)
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
    trace.reset()
    m.match_device(data)
    assert sum(trace.launches(*sieve.KERNELS).values()) == 1
    assert _n("walk_kernel") == 1
    assert _n("sieve_smem_kernel") == 1
    assert trace.launches(*compact.KERNELS) == {"compact_scan_kernel": 1,
                                           "compact_kernel": 1}
    assert _n("block_walk_kernel") == 1  # armed: one launch, no dense block


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
    # the Snort-scale walk tables do not fit K3 beside its tile buffers:
    # deep steps are read through L1/L2, shallow ones from shared memory
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
    trace.reset()
    block_walk.block_walk(data, n, counts, match, eng._walk)
    torch.cuda.synchronize()
    assert _n("block_walk_kernel") == 1 and torch.equal(match, before)


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
    trace.reset()
    res = m.match_device(data)
    assert sum(trace.launches(*sieve.KERNELS).values()) == 1
    assert _n("block_walk_kernel") == 0
    assert _n("csr_walk_kernel") == 1      # whatever the survivor count
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


def _n(kernel: str) -> int:
    return trace.counters()[f"launch.{kernel}"]


@pytest.mark.parametrize("placement", sieve.PLACEMENTS)
@pytest.mark.parametrize("n", [5, 65536, 300_001, 3 << 20])
def test_sieve_placements_match_plain(dev, placement, n):
    # every placement, forced, on a walk-tier and a CSR-tier ruleset
    for pats, rng in (_ruleset(n + 1), _csr_ruleset()):
        tabs = pt.Matcher(pats, device=dev)._engine()._sieve
        host = _corpus(rng, pats, max(n, 200))[:n]
        data = torch.from_numpy(host).to(dev)
        npad = npad_for(n)
        trace.reset()
        got = sieve.sieve(data, n, npad, tabs, placement=placement)
        assert _n(f"sieve_{placement}_kernel") == 1
        want = sieve.sieve_plain(data, n, npad, tabs)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _gate_cases():
    """(name, patterns, host bytes) for K1's gates: text whose bytes open a
    gate and miss; m2 and m3 hits at a byte that is also a 1-byte pattern;
    m2 and m3 with displacements (over 64 keys each); the wide m2 (> 0x7FFF
    IDs); no pattern of 2 or 3 bytes, so no gate opens."""
    rng = np.random.default_rng(19)
    longs = [b"Aqqqq", b"Bxyzw", b"\x00\x01\x02\x03"]
    miss = [b"Aq", b"Aqr", b"Bz", b"Bzz", b"A", b"\xff\x00"] + longs
    text = rng.choice(np.frombuffer(b"ABqrxz\xff\x00", np.uint8),
                      size=300_001)
    text[:8] = np.frombuffer(b"ABABAAAB", np.uint8)   # gates open, misses
    hits = [b"A", b"AB", b"ABC", b"B", b"BC"] + longs
    htext = np.frombuffer(b"ABCABAxBCABBA" * 23_077, np.uint8).copy()
    keys = rng.choice(1 << 16, size=33_000, replace=False)
    wide = [bytes([k >> 8, k & 0xFF]) for k in keys] + [b"XYZ", b"q"] + longs
    wtext = rng.integers(0, 256, size=300_001, dtype=np.uint8)
    chd = [bytes(rng.integers(0, 256, size=k, dtype=np.uint8))
           for k in [2] * 400 + [3] * 300] + [b"Q"] + longs
    ctext = rng.integers(0, 256, size=300_001, dtype=np.uint8)
    for off in range(0, 300_000 - 3, 5):
        p = chd[int(rng.integers(0, 700))]
        ctext[off:off + len(p)] = np.frombuffer(p, np.uint8)
    none = [b"abcd", b"bcde", b"q"] + longs
    ntext = rng.choice(np.frombuffer(b"abcdeq", np.uint8), size=300_001)
    return [("gate_miss", miss, text), ("hit_on_1byte", hits, htext),
            ("displaced", chd, ctext), ("wide", wide, wtext),
            ("no_short", none, ntext)]


@pytest.mark.parametrize("placement", sieve.PLACEMENTS)
@pytest.mark.parametrize("case", range(5))
def test_sieve_gates_match_plain(dev, placement, case):
    # every placement, forced, bit-equal to the plain sieve where the gates
    # open and miss, where m2/m3 hit over a 1-byte pattern, with n ending
    # 1, 2 and 3 bytes into a short pattern, on displaced tables, and where
    # no gate opens; a placement the tables do not fit raises
    name, pats, host = _gate_cases()[case]
    tabs = pt.Matcher(pats, device=dev)._engine()._sieve
    d = torch.from_numpy(host).to(dev)
    if name == "displaced":
        assert tabs.rows[0][3] >= 0 and tabs.rows[1][3] >= 0
    if sieve.smem_bytes(placement, tabs) > sieve.SMEM_LIMIT:
        assert name == "wide" and placement != "global"
        with pytest.raises(ValueError, match="shared memory"):
            sieve.sieve(d, 8192, 65536, tabs, placement=placement)
        return
    ends = [host.shape[0]]
    at = host.tobytes().find(b"ABC") if name == "hit_on_1byte" else -1
    if at >= 0:
        ends += [at + 1, at + 2, at + 3]
    for n in ends:
        npad = npad_for(n)
        got = sieve.sieve(d, n, npad, tabs, placement=placement)
        want = sieve.sieve_plain(d, n, npad, tabs)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), (name, n)
    if name == "hit_on_1byte":
        assert int((got[0] == 3).sum()) > 0 and int((got[0] == 5).sum()) > 0


@pytest.mark.parametrize("placement", sieve.PLACEMENTS)
def test_sieve_gates_keep_an_id_just_under_2_30(dev, placement):
    # m1 words of 2^30 - 1 and 2^30 - 2, one of them under both gates: the
    # kernel masks its gates off every ID it writes
    import dataclasses
    top = (1 << 30) - 1
    pats = [b"A", b"AB", b"ABC", b"B", b"Bqrs", b"xyzw"]
    tabs = pt.Matcher(pats, device=dev)._engine()._sieve
    tabs = dataclasses.replace(tabs, arena=tabs.arena.clone())
    tabs.arena[ord("A")] = top
    tabs.arena[ord("B")] = top - 1
    assert int(sieve.gated_m1(tabs)[ord("A")]) >> 30 == 3
    host = np.frombuffer(b"ABCABAxBAqBqrs" * 20_000, np.uint8).copy()
    d = torch.from_numpy(host).to(dev)
    n = host.shape[0]
    got = sieve.sieve(d, n, npad_for(n), tabs, placement=placement)
    want = sieve.sieve_plain(d, n, npad_for(n), tabs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[0] == top).sum()) == 20_000 * 2


@pytest.fixture(scope="module")
def clamav_set():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    brng = np.random.default_rng(7)
    pats = rulesets.clamav_like_patterns(brng)
    m = pt.Matcher(pats, device="cuda")
    return m, rulesets.planted_text(brng, pats, 4 << 20, 0.002)


@pytest.mark.parametrize("placement", ["cluster", "global"])
def test_sieve_gates_100k_set(dev, clamav_set, placement):
    # the 100K set (no pattern under 8 bytes: no gate opens) in the two
    # placements its arena fits, bit-equal to the plain sieve
    m, host = clamav_set
    tabs = m._engine()._sieve
    assert not (sieve.gated_m1(tabs) >> 30).any()
    d = torch.from_numpy(host).to(dev)
    n = host.shape[0] - 3
    got = sieve.sieve(d, n, npad_for(n), tabs, placement=placement)
    want = sieve.sieve_plain(d, n, npad_for(n), tabs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("placement", sieve.PLACEMENTS)
def test_short_probes_equal_a_host_recount(dev, placement, monkeypatch):
    # the program's K1, forced into each placement, adds the m2 and m3 key
    # probes it issued to the device counters: the gate rule recounted on
    # the host (sieve.short_probes_plain), over lengths that cut a tile
    monkeypatch.setattr(sieve, "placement_for", lambda tabs: placement)
    pats = rulesets.snort_like_patterns()
    m = pt.Matcher(pats, device=dev)
    tabs = m._engine()._sieve
    rng = np.random.default_rng(23)
    text = rulesets.planted_text(rng, pats, 3 << 20, 0.015)
    inputs = [torch.from_numpy(text[:n]).to(dev)
              for n in (1, 5, 300_001, 3 << 20)]
    inputs.append(torch.from_numpy(
        rng.integers(0, 256, size=1 << 20, dtype=np.uint8)).to(dev))
    want = sum(sieve.short_probes_plain(d, d.shape[0], tabs) for d in inputs)
    m.match_device(inputs[0])
    trace.reset()
    for d in inputs:
        got = m.match_device(d)
        assert _n(f"sieve_{placement}_kernel") >= 1
    assert torch.equal(got, pipeline.run(
        inputs[-1], 1 << 20, npad_for(1 << 20), tabs, m._engine()._walk,
        plain=True))
    c = m.counters()
    assert c["short_probes"] == want > 0
    share = sieve.short_probes_plain(inputs[3], 3 << 20, tabs) / (6 << 20)
    assert 0.15 < share < 0.35, share


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


def _chunk_flags(rng, npad: int, block: int, case: str) -> np.ndarray:
    """Survivor flags shaped to csrc/compact.cu's rounds: a warp lists its
    run of block / 256 bitmap words in rounds of up to 8 chunks of 32
    words, lane by lane where the round holds at most compact.ROUND_MAX
    set bits, else word by word:
    * ``round_max``: every round exactly ROUND_MAX bits, so every round is
      listed lane by lane and fills the warp's stage;
    * ``round_max_or_above``: every round ROUND_MAX or one bit more at
      random, so the two ways interleave;
    * ``full_and_empty``: words all set or all clear, the share of full
      words drawn a block, so some blocks are listed and some dense."""
    words = npad // 32
    if case == "full_and_empty":
        share = np.repeat(rng.random(npad // block) * 0.4, block // 32)
        return np.repeat(rng.random(words) < share, 32).astype(np.uint8)
    flags = np.zeros(((npad // block) * 8, block // 8), np.uint8)  # runs
    for r in range(0, block // 8, 8192):        # a round: 8 chunks' bits
        keys = rng.random((len(flags), min(8192, block // 8 - r)))
        top = compact.ROUND_MAX + (
            rng.integers(0, 2, size=(len(flags), 1))
            if case == "round_max_or_above" else 0)
        flags[:, r:r + 8192] = keys.argsort(1).argsort(1) < top
    return flags.reshape(-1)


@pytest.mark.parametrize("density", [0.0, 1e-4, 0.01, 0.3, 1.0, 0.047,
                                     "round_max", "round_max_or_above",
                                     "full_and_empty", "unaligned",
                                     "sliced_bits"])
@pytest.mark.parametrize("block", [8192, 65536, 81920])
def test_compact_kernel_matches_plain(dev, density, block):
    # the cell's density (0.047), rounds at and one bit above the switch
    # from lane-wise to word-wise listing, full words among empty ones,
    # blocks listed at offsets that are not multiples of 4 (a sparse block
    # of 1 and one of 2 survivors first, then one with a full word in a
    # sparse round) and a bitmap that is a view off its 16-byte line, in
    # blocks of 1, 8 and 10 chunks a warp (past 8, a warp reads its later
    # words again), bit-equal to the plain compaction at each threshold,
    # with the chunks listed word by word equal to the host's recount
    seed = (int(density * 1e4) if isinstance(density, float)
            else len(density)) + block
    rng = np.random.default_rng(seed)
    npad = 37 * block
    if isinstance(density, float) or density in ("unaligned",
                                                  "sliced_bits"):
        p = density if isinstance(density, float) else 0.047
        flags = (rng.random(npad) < p).astype(np.uint8)
    else:
        flags = _chunk_flags(rng, npad, block, density)
    if density == "unaligned":
        flags[:2 * block] = 0
        flags[[77, block + 5, block + 4000]] = 1
        flags[2 * block + 64:2 * block + 96] = 1     # a full word, sparse
    flags = torch.from_numpy(flags)
    if density != 1.0:
        flags[5 * block:6 * block] = 1          # one dense block
    flags[-1] = 1                       # the last word of the last block
    flags = flags.to(dev)
    bits = sieve.pack_bits(flags)
    if density == "sliced_bits":
        bits = torch.cat([bits[:1], bits])[1:]
        assert bits.data_ptr() % 16 == 4
    counts = flags.view(-1, block).sum(1, dtype=torch.int32)
    if density == "unaligned":
        starts = torch.cumsum(counts, 0) - counts
        assert (starts[1:3] % 4 != 0).all()
    for thresh in (block // 4, block + 1, 1):
        trace.reset()
        counters = torch.zeros(1, dtype=torch.int64, device=dev)
        got, count = compact.compact(bits, counts, thresh, counters)
        assert trace.launches(*compact.KERNELS) == {"compact_scan_kernel": 1,
                                               "compact_kernel": 1}
        assert got.numel() == compact.capacity(counts.numel(), block, thresh)
        assert torch.equal(got[:int(count)],
                           compact.compact_plain(bits, counts, thresh))
        assert int(counters) == compact.wordwise_chunks_plain(bits, counts,
                                                              thresh)


def test_compact_launch_refuses_unaligned_buffers(dev):
    # compact_kernel loads the bitmap 16 bytes a lane and writes pos in
    # whole 128-byte lines: a bitmap off 16 bytes or a pos off its line is
    # refused (cudaErrorInvalidValue), and the aligned call runs
    block = 65536
    flags = (torch.rand(2 * block, device=dev) < 0.047).to(torch.uint8)
    bits = sieve.pack_bits(flags)
    counts = flags.view(-1, block).sum(1, dtype=torch.int32)
    offsets = torch.zeros(3, dtype=torch.int32, device=dev)
    pos = torch.empty(2 * block + 32, dtype=torch.int32, device=dev)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    call = lambda b, p: lib.pfac_compact(
        dev.index or 0, b, counts.data_ptr(), offsets.data_ptr(), 2, block,
        block // 4, p, None, stream)
    assert call(bits.data_ptr() + 4, pos.data_ptr()) == 1
    assert call(bits.data_ptr(), pos.data_ptr() + 64) == 1
    assert call(bits.data_ptr(), pos.data_ptr()) == 0
    torch.cuda.synchronize(dev)


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
        kernel = "walk_kernel" if fn is walk else "csr_walk_kernel"
        for name, buf, cnt in _count_cases(dev, pos):
            trace.reset()
            out_k, out_p = match.clone(), match.clone()
            run(data, n, buf, out_k, tabs, cnt)
            k = buf.numel() if cnt is None else int(cnt)
            plain(data, n, buf[:k].clone(), out_p, tabs)
            torch.cuda.synchronize()
            assert _n(kernel) == 1, name
            assert torch.equal(out_k, out_p), name
            assert (k == 0) == torch.equal(out_k, match), name


@pytest.mark.parametrize("which", ["none", "entry", "prefix", "plan", "all"])
def test_walk_resident_prefixes(dev, which, monkeypatch):
    # K2 with none, the entry tables, the prefix of the tables K3 holds
    # beside its tiles, the plan (the Snort-like set's tables whole) and a
    # small set's whole tables in shared memory
    pats = (_ruleset(4)[0] if which == "all"
            else rulesets.snort_like_patterns())
    eng = pt.Matcher(pats, device=dev)._engine()
    tabs = eng._walk
    nsteps, planned = walk.launch_plan(tabs, dev)
    words = tabs.arena.numel()
    n = 4 << 20
    resident = {"none": 0, "entry": walk.table_ends(tabs)[1],
                "prefix": block_walk.launch_plan(
                    tabs, npad_for(n) // block_walk.CHUNK, dev)[3],
                "plan": planned, "all": words}[which]
    assert planned == words
    assert which != "prefix" or 0 < resident < words
    monkeypatch.setattr(walk, "launch_plan", lambda t, d: (nsteps, resident))
    rng = np.random.default_rng(8)
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
    # K2 keeps the entry tables; nothing of the walk tables fits K3
    assert walk.launch_plan(eng._walk, dev)[1] in walk.table_ends(
        eng._walk)[:2]
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
    trace.reset()
    got = gathers.word_gather(table, idx, placement)
    assert _n(gathers.word_kernel(w, placement, n)) == 1
    assert sum(trace.launches(*gathers.KERNELS).values()) == 1
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
    trace.reset()
    got = gathers.word_gather(table, idx, placement)
    kernel = gathers.word_kernel(w, placement, idx.numel())
    assert _n(kernel) == 1
    assert sum(trace.launches(*gathers.KERNELS).values()) == 1
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
        trace.reset()
        assert torch.equal(gathers.tile_gather(tile, idx, axis, path), want)
        assert _n(kernel) == 1


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
    trace.reset()
    for item in make(dev):
        if isinstance(item, harness.Refusal):
            harness.refuse(item)
        else:
            assert harness.check(item) == 0
    assert sum(trace.launches(*gathers.KERNELS).values()) > 0


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
    on_cpu = XlaMatcher(a, perf_mode=mode, device="cpu").match_device(
        data.cpu())
    assert torch.equal(on_card.cpu(), on_cpu)
    sieve_res = pt.Matcher(automaton=a, device=dev).match_device(data)
    assert torch.equal(on_card[:n], sieve_res[:n])
    assert on_cpu[:n].tolist() == golden.match_edges_batch(a, host).tolist()
    m = pt.Matcher(automaton=a, device=dev, backend="xla", perf_mode=mode)
    assert isinstance(m._engine(), XlaMatcher)
    assert m.match(host.tobytes()).tolist() == on_cpu[:n].tolist()


def _lockstep_pair(data, n, npad, tables, mode, num_final, max_len,
                   pairs=None):
    """The lockstep kernel and its plain version on the same card inputs;
    the kernel's call counted (one launch of its mode's kernel) and run
    where any host synchronisation raises -> (kernel, plain)."""
    from pfac_tpu_torch.backends import lockstep
    kw = dict(perf_mode=mode, num_final=num_final, max_len=max_len)
    want = lockstep.lockstep_walk_plain(
        data, n, torch.empty(npad, dtype=torch.int32, device=data.device),
        tables, **kw)
    out = torch.full((npad,), -7, dtype=torch.int32, device=data.device)
    torch.cuda.synchronize()
    kernels = tuple(lockstep.KERNELS.values())
    before = trace.launches(*kernels)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = lockstep.lockstep_walk(data, n, out, tables, pairs=pairs,
                                     **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert got is out
    after = trace.launches(*kernels)
    assert {k: c - before[k] for k, c in after.items()} == {
        k: int(k == lockstep.KERNELS[mode]) for k in kernels}
    return got, want


def _lockstep_placements(data, n, npad, m):
    """_lockstep_pair in each placement the XlaMatcher `m`'s pair states
    take (smem where their form fits, and global), each equal to the plain
    version -> the kernel's result."""
    a = m.automaton
    places = [(None, "global")]
    if m.placement == "smem":
        places.append((m._pairs, "smem"))
    for pairs, placement in places:
        got, want = _lockstep_pair(data, n, npad, m._tables, m.perf_mode,
                                   a.num_final_states, a.max_pattern_len,
                                   pairs)
        assert torch.equal(got, want), placement
        assert not got[n:].any(), placement
    return got


@pytest.mark.parametrize("mode", ["dense", "hash"])
@pytest.mark.parametrize("n", [1, 1000, 131_073, 600_001])
def test_lockstep_kernel_matches_plain(dev, mode, n):
    # the kernel in each placement against its plain version, bit for bit,
    # on the sizes of test_lockstep_walker_on_card; a buffer longer than n
    # (bytes past n are the sentinel), and the tail past n all 0
    from pfac_tpu_torch.backends.xla import DEFAULT_TILE, XlaMatcher
    pats, rng = _ruleset(n + 17)
    a = pt.Automaton.from_patterns(pats)
    host = _corpus(rng, pats, max(n, 200) + 300)
    data = torch.from_numpy(host).to(dev)
    m = XlaMatcher(a, perf_mode=mode, device=dev)
    assert m.placement == "smem"
    npad = -(-n // DEFAULT_TILE) * DEFAULT_TILE
    for npad_ in (npad, n + 3):
        got = _lockstep_placements(data, n, npad_, m)
        if npad_ == npad:
            assert torch.equal(m.match_device(data[:n]), got)


README_PATTERNS = [b"AB", b"ABG", b"BEDE", b"ED"]


def _lockstep_cases():
    """name -> (patterns, host bytes, n) of the kernel's edge cases."""
    rng = np.random.default_rng(4096)
    snort = rulesets.snort_like_patterns()
    cut_host = rulesets.planted_text(rng, snort, 3 * 4096 + 777, 0.05)
    concat = b"".join(snort[i] for i in rng.permutation(len(snort)))
    concat = np.frombuffer(concat * -(-(8 << 20) // len(concat)),
                           np.uint8)[: 8 << 20]
    long = rng.integers(0, 256, size=1000, dtype=np.uint8)
    across = rng.integers(0, 256, size=8 << 20, dtype=np.uint8)
    for off in range(77, across.shape[0] - 1000, 9_000):
        across[off:off + 1000] = long
    return {
        "conformance": (README_PATTERNS, np.frombuffer(b"ABEDEDABG",
                                                       np.uint8), 9),
        "n0": (README_PATTERNS, np.zeros(0, np.uint8), 0),
        "n1": (README_PATTERNS, np.frombuffer(b"A", np.uint8), 1),
        "n2": (README_PATTERNS, np.frombuffer(b"AB", np.uint8), 2),
        # n not a multiple of the kernel's 4,096-position tile, in a
        # buffer 500 bytes longer
        "cut_tile": (snort, cut_host, 3 * 4096 + 277),
        # every position of every tile walks to depth 4
        "all_walk": ([b"aaaa"], np.full(5 * 4096 + 3, ord("a"), np.uint8),
                     5 * 4096 + 3),
        # long walks everywhere, 8 MB: more tiles than CTAs, so walks are
        # carried from one tile's walk phase to the next
        "snort_concatenated": (snort, concat, concat.shape[0]),
        # 1,000-step walks across many tiles
        "long_walks": ([long.tobytes(), long[:3].tobytes()], across,
                       across.shape[0] - 5),
    }


@pytest.mark.parametrize("mode", ["dense", "hash"])
@pytest.mark.parametrize("case", ["conformance", "n0", "n1", "n2",
                                  "cut_tile", "all_walk",
                                  "snort_concatenated", "long_walks"])
def test_lockstep_kernel_cases(dev, mode, case):
    # each kernel in each placement against its plain version: one launch
    # a call, no host synchronisation, bit-equal, and equal to golden
    from pfac_tpu_torch.backends.xla import XlaMatcher
    pats, host, n = _lockstep_cases()[case]
    a = pt.Automaton.from_patterns(pats, hashed=mode == "hash")
    m = XlaMatcher(a, perf_mode=mode, tile=4096, device=dev)
    data = torch.from_numpy(host.copy()).to(dev)
    npad = max(1, -(-n // 4096)) * 4096
    got = _lockstep_placements(data, n, npad, m)
    if n:
        assert got[:n].cpu().tolist() == golden.match_edges_batch(
            a, host[:n]).tolist()
    if case == "conformance":
        assert got[:9].tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]
    if case == "all_walk":
        assert (got[:n - 3] == 1).all() and not got[n - 3:].any()


@pytest.mark.parametrize("mode", ["dense", "hash"])
def test_lockstep_kernel_thousand_byte_pattern(dev, mode):
    rng = np.random.default_rng(1000)
    long = rng.integers(0, 256, size=1000, dtype=np.uint8).tobytes()
    pats = [long, long[:3], long[500:504]]
    host = rng.integers(0, 256, size=70_000, dtype=np.uint8)
    for off in range(100, 66_000, 6_500):
        host[off:off + 1000] = np.frombuffer(long, np.uint8)
    host[-600:] = np.frombuffer(long[:600], np.uint8)    # cut by the end
    a = pt.Automaton.from_patterns(pats)
    from pfac_tpu_torch.backends.xla import XlaMatcher
    m = XlaMatcher(a, perf_mode=mode, tile=4096, device=dev)
    data = torch.from_numpy(host).to(dev)
    got = _lockstep_placements(data, host.shape[0], 18 * 4096, m)
    assert int(got[100]) == 1
    assert int(got[host.shape[0] - 600]) == 2
    assert got[:host.shape[0]].tolist() == golden.match_edges_batch(
        a, host).tolist()


def test_lockstep_kernel_negative_hash_keys(dev):
    # synthetic hash tables whose keys all have k >= 32768 (a negative
    # int32 key; no ruleset yields one): the kernel's shifts are
    # arithmetic, as the plain version's. The pair match is derived from
    # the pair state as xla.pair_tables derives it (the kernel reads its
    # column 256 only); the form in shared memory takes the letters' pairs
    from pfac_tpu_torch.backends import lockstep
    rng = np.random.default_rng(5)
    states, slots = 40, 256
    e = states * slots
    rp_off = np.arange(states, dtype=np.int64) * slots
    rp_key = ((rng.integers(32768, 65536, size=states) << 16)
              | (slots - 1)).astype(np.uint32).view(np.int32)
    rp_off[0], rp_key[0] = e, 0
    val_next, val_ch = np.zeros(e + 1, np.int32), np.full(e + 1, -1, np.int32)
    letters = np.arange(60, 66)
    for s in range(1, states):
        key = np.int32(rp_key[s])
        for ch in rng.choice(letters, size=3, replace=False):
            x = (key >> 16) * np.int32(ch)
            beta = (x & 0xFF) - (x >> 8)
            slot = int(rp_off[s]) + int((beta + 257 if beta < 0 else beta)
                                        & (key & 0xFFFF))
            val_ch[slot], val_next[slot] = ch, rng.integers(0, states)
    ps = rng.integers(0, states, size=(257, 257)).astype(np.int32)
    ps[256, :] = ps[:, 256] = 0
    m1 = rng.integers(0, 13, size=257).astype(np.int32)
    m1[256] = 0
    data = torch.from_numpy(rng.choice(letters, size=200_000)
                            .astype(np.uint8)).to(dev)
    steps = [torch.from_numpy(t).to(dev)
             for t in (rp_off.astype(np.int32), rp_key, val_next, val_ch)]
    live = np.zeros((257, 257), bool)
    live[np.ix_(letters, letters)] = True
    for pair_state, smem in ((ps, False), (np.where(live, ps, 0), True)):
        pm = np.where((pair_state >= 1) & (pair_state <= 12), pair_state,
                      m1[:, None]).astype(np.int32)
        form = torch.from_numpy(lockstep.pair_form(pair_state)).to(dev)
        tables = (torch.from_numpy(pair_state.reshape(-1)).to(dev),
                  torch.from_numpy(pm.reshape(-1)).to(dev), *steps)
        got, want = _lockstep_pair(data, 199_990, 200_704, tables, "hash",
                                   12, 9, form if smem else None)
        assert torch.equal(got, want) and int((got > 0).sum()) > 1000


def test_lockstep_kernel_100k_set(dev):
    # the 100K set (dense; 6.16 GB of table) on 1 MB of its corpus: its
    # pair states take the global placement, its form forced on the
    # kernel raises; the kernel equals its plain version, the sieve engine
    # and golden
    from pfac_tpu_torch.backends import lockstep
    from pfac_tpu_torch.backends.xla import XlaMatcher
    brng = np.random.default_rng(7)
    pats = rulesets.clamav_like_patterns(brng)
    a = pt.Automaton.from_patterns(pats)
    host = rulesets.planted_text(brng, pats, 1 << 20, 0.002)
    data = torch.from_numpy(host).to(dev)
    m = XlaMatcher(a, device=dev)
    assert m.placement == "global" and m._pairs is None
    form = torch.from_numpy(lockstep.pair_form(m._tables[0].cpu().numpy()))
    with pytest.raises(ValueError, match="budget"):
        lockstep.lockstep_walk(
            data, host.shape[0], torch.empty(1 << 20, dtype=torch.int32,
                                             device=dev), m._tables,
            perf_mode="dense", num_final=a.num_final_states,
            max_len=a.max_pattern_len, pairs=form.to(dev))
    got = _lockstep_placements(data, host.shape[0], 1 << 20, m)
    del m
    torch.cuda.empty_cache()
    sieve_res = pt.Matcher(automaton=a, device=dev).match_device(data)
    assert torch.equal(got, sieve_res[:1 << 20])
    assert got.cpu().tolist() == golden.match_edges_batch(a, host).tolist()


def test_every_walker_tier_launches_the_kernel(dev, monkeypatch):
    # Backend.XLA dense and hash, PlacementMode.HBM and the fallback from a
    # sieve-table budget of 0: one kernel launch a match_device, no host
    # synchronisation, no aten::nonzero; match_reduce_device the same
    from torch.profiler import ProfilerActivity, profile

    from pfac_tpu_torch.backends import lockstep
    from pfac_tpu_torch.backends.xla import XlaMatcher
    pats, rng = _ruleset(4242)
    host = _corpus(rng, pats, 300_001)
    data = torch.from_numpy(host).to(dev)
    a = pt.Automaton.from_patterns(pats)
    want = pt.Matcher(automaton=a, device=dev).match_device(data)
    tiers = {"xla dense": dict(backend="xla"),
             "xla hash": dict(backend="xla", perf_mode="hash"),
             "hbm": dict(placement="hbm")}
    mts = {k: pt.Matcher(automaton=a, device=dev, **kw)
           for k, kw in tiers.items()}
    monkeypatch.setattr(sieve_matcher, "_VMEM_TABLE_BUDGET", 0)
    mts["fallback"] = pt.Matcher(automaton=a, device=dev)
    for tier, mt in mts.items():
        eng = mt._engine()
        assert isinstance(eng, XlaMatcher), tier
        mt.match_device(data)
        torch.cuda.synchronize()
        kernels = tuple(lockstep.KERNELS.values())
        before = trace.launches(*kernels)
        torch.cuda.set_sync_debug_mode("error")
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                got = mt.match_device(data)
                ids, pos, cnt = mt.match_reduce_device(data)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        kernel = lockstep.KERNELS[eng.perf_mode]
        after = trace.launches(*kernels)
        assert {k: c - before[k] for k, c in after.items()} == {
            k: 2 * int(k == kernel) for k in kernels}, tier
        assert not any(e.key == "aten::nonzero"
                       for e in prof.key_averages()), tier
        assert torch.equal(got[:host.shape[0]], want[:host.shape[0]]), tier
        assert int(cnt) == int((got > 0).sum()), tier


@pytest.mark.parametrize("mode", ["dense", "hash"])
@pytest.mark.parametrize("k", [2, 4])
def test_sharded_walker_through_the_kernel(dev, mode, k):
    # the walker engine on k shards of one card: one kernel launch a
    # shard, equal in full to the single device's walker
    from pfac_tpu_torch.backends import lockstep
    from pfac_tpu_torch.backends.xla import XlaMatcher
    from pfac_tpu_torch.dist.sharding import ShardedMatcher, make_data_mesh
    pats, rng = _ruleset(99 + k)
    host = _corpus(rng, pats, 1_000_003)
    a = pt.Automaton.from_patterns(pats)
    sm = ShardedMatcher(a, mesh=make_data_mesh(devices=[dev] * k),
                        perf_mode=mode, tile=4096, engine="xla")
    single = XlaMatcher(a, perf_mode=mode, tile=4096, device=dev)
    want = single.match_device(torch.from_numpy(host).to(dev))
    n = host.shape[0]
    shards = sm._put(host, sm._shard_len(n))
    torch.cuda.synchronize()
    kernels = tuple(lockstep.KERNELS.values())
    before = trace.launches(*kernels)
    res, cnt = sm.match_device(shards, n)
    assert {c: x - before[c] for c, x in trace.launches(*kernels).items()} == {
        c: k * int(c == lockstep.KERNELS[mode]) for c in kernels}
    assert torch.equal(torch.cat(res)[:n], want[:n])
    assert int(cnt) == int((want > 0).sum())
    assert np.array_equal(sm.match(host), want[:n].cpu().numpy())


def test_graft_entry_walks_through_the_kernel(dev):
    # entry()'s fn on the card is one launch of the dense kernel, equal to
    # its result on the CPU (the plain version)
    from pfac_tpu_torch.backends import lockstep
    fn, args = graft_entry.entry(dev)
    cpu_fn, cpu_args = graft_entry.entry("cpu")
    before = _n("lockstep_dense_kernel")
    out = fn(*args)
    assert _n("lockstep_dense_kernel") == before + 1
    assert torch.equal(out.cpu(), cpu_fn(*cpu_args))


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
    before = trace.launches(*reduce.KERNELS)
    want = reduce.reduce_plain(r)
    for _ in range(2):
        ids, pos, count = reduce.reduce_from_dense(r)
        assert count.dim() == 0 and int(count) == int(want[2])
        assert torch.equal(ids, want[0]) and torch.equal(pos, want[1])
        for status, _ in reduce._SCRATCH.values():
            assert int(status[0]) == 0
    assert {k: n - before[k] for k, n in
            trace.launches(*reduce.KERNELS).items()} == {
        "reduce_kernel": 2, "reduce_tail_kernel": 2}


def test_reduce_does_not_synchronize(dev):
    # match_reduce_device on both engines under the sync debug mode: the
    # reduce launches reduce_kernel and reduce_tail_kernel and never waits
    # for the device, nor does the lockstep walker's match_device; the
    # sieve engine's compaction runs once
    from pfac_tpu_torch.backends import reduce
    from pfac_tpu_torch.backends.xla import XlaMatcher
    pats, rng = _ruleset(77)
    host = _corpus(rng, pats, 300_001)
    data = torch.from_numpy(host).to(dev)
    m = pt.Matcher(pats, device=dev)
    m.match_reduce_device(data)                   # warm
    xm = XlaMatcher(m.automaton, device=dev)
    torch.cuda.synchronize()
    counts = (_n("reduce_kernel"), _n("reduce_tail_kernel"),
              _n("compact_kernel"))
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = m.match_reduce_device(data)
        xgot = reduce.reduce_from_dense(xm.match_device(data))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (_n("reduce_kernel") - counts[0],
            _n("reduce_tail_kernel") - counts[1],
            _n("compact_kernel") - counts[2]) == (2, 2, 1)
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
    # an input shorter than the mesh: the shards past it run on no bytes
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


# --------------------------------------------------------------- programs
def _wrappers(eng, data, n, npad):
    """The per-kernel wrappers' chain (pipeline.run) on the card."""
    return pipeline.run(data, n, npad, eng._sieve, eng._walk, eng._csr,
                        block=eng.tile_rows * 128)


def test_program_equals_pipeline_over_lengths(dev):
    # one matcher, a sequence of lengths and npads (back to ones seen
    # before): each call one program launch, equal to the wrappers' chain
    # and to the plain pipeline; one program a (device, npad)
    pats, rng = _ruleset(51)
    m = pt.Matcher(pats, device=dev)
    eng = m._engine()
    host = _corpus(rng, pats, 3 << 20)
    lengths = [5, 65536, 65537, 300_001, 3 << 20, 70_000, 5, 1]
    for n in lengths:
        data = torch.from_numpy(host[:n].copy()).to(dev)
        before = _n("program")
        got = m.match_device(data)
        assert _n("program") == before + 1
        npad = npad_for(n)
        assert torch.equal(got, _wrappers(eng, data, n, npad)), n
        assert torch.equal(got, pipeline.run(data, n, npad, eng._sieve,
                                             eng._walk, plain=True)), n
    npads = {npad_for(n) for n in lengths}
    assert set(eng._programs) == {(dev.index or 0, p, False) for p in npads}


@pytest.mark.parametrize("offset", [1, 3, 15])
def test_program_unaligned_view(dev, offset):
    pats, rng = _ruleset(53)
    m = pt.Matcher(pats, device=dev)
    eng = m._engine()
    base = torch.from_numpy(_corpus(rng, pats, 1 << 20)).to(dev)
    view = base[offset:]
    assert view.data_ptr() % 16
    n = view.shape[0]
    assert torch.equal(m.match_device(view),
                       _wrappers(eng, view.clone(), n, npad_for(n)))


def test_program_two_streams_two_matchers(dev):
    # two matchers of one npad, each on its own stream, calls interleaved:
    # no buffer is shared, so every result equals its matcher's own chain
    sets = [_ruleset(55), _csr_ruleset()]
    ms = [pt.Matcher(p, device=dev) for p, _ in sets]
    datas = [torch.from_numpy(_corpus(rng, p, 2 << 20)).to(dev)
             for p, rng in sets]
    want = [_wrappers(m._engine(), d, d.shape[0], npad_for(d.shape[0]))
            for m, d in zip(ms, datas)]
    streams = [torch.cuda.Stream(dev) for _ in ms]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    got = [[], []]
    for _ in range(4):
        for k, (m, d, s) in enumerate(zip(ms, datas, streams)):
            with torch.cuda.stream(s):
                got[k].append(m.match_device(d))
    torch.cuda.synchronize()
    for k in range(2):
        assert all(torch.equal(g, want[k]) for g in got[k])


@pytest.mark.parametrize("placement", sieve.PLACEMENTS)
def test_program_csr_tier_every_placement(dev, placement, monkeypatch):
    # the CSR tier with K1 in each placement (forced), the cluster's
    # dimensions kept in the graph node across updates
    pats, rng = _csr_ruleset()
    m = pt.Matcher(pats, device=dev)
    eng = m._engine()
    assert eng._csr is not None
    monkeypatch.setattr(sieve, "placement_for", lambda tabs: placement)
    for n in (300_001, 1 << 20, 300_001):
        host = _corpus(rng, pats, n)
        data = torch.from_numpy(host).to(dev)
        trace.reset()
        got = m.match_device(data)
        assert _n(f"sieve_{placement}_kernel") == 1
        assert torch.equal(got, pipeline.run(data, n, npad_for(n),
                                             eng._sieve, None, eng._csr,
                                             plain=True))


def test_program_sieve_only_tier(dev):
    # patterns of at most 3 bytes: K1 alone, then the reduce
    m = pt.Matcher([b"AB", b"ABG", b"B", b"xyz"], device=dev)
    eng = m._engine()
    host = np.frombuffer(b"ABGxyzAB" * 40_000, np.uint8).copy()
    data = torch.from_numpy(host).to(dev)
    n = host.shape[0]
    got = m.match_device(data)
    geo = eng._programs[(dev.index or 0, npad_for(n), False)].geo
    assert torch.equal(got, _wrappers(eng, data, n, npad_for(n)))
    assert got[:n].cpu().numpy().tolist() == golden.match_edges_batch(
        m.automaton, host).tolist()
    ids, pos, cnt = m.match_reduce_device(data)
    w_ids, w_pos, w_cnt = reduce.reduce_plain(got)
    assert geo.tier in program.TIERS and int(cnt) == int(w_cnt)
    assert torch.equal(ids, w_ids) and torch.equal(pos, w_pos)


@pytest.mark.parametrize("tier", ["walk", "csr"])
def test_program_reduce_and_launches(dev, tier):
    # match_reduce_device: one program launch, the reduce's kernels behind
    # the pipeline's once each, equal to reduce_plain of the match; a first
    # call at a new length under set_sync_debug_mode("error")
    pats, rng = _ruleset(57) if tier == "walk" else _csr_ruleset()
    m = pt.Matcher(pats, device=dev)
    m._engine()                 # the tables on the card before the check
    data = torch.from_numpy(_corpus(rng, pats, 1_500_000)).to(dev)
    torch.cuda.synchronize()
    trace.reset()
    before = _n("program")
    torch.cuda.set_sync_debug_mode("error")
    try:
        ids, pos, cnt = m.match_reduce_device(data)
        res = m.match_device(data)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _n("program") == before + 2
    assert sum(trace.launches(*sieve.KERNELS).values()) == 2
    assert trace.launches(*compact.KERNELS) == {"compact_scan_kernel": 2,
                                           "compact_kernel": 2}
    assert trace.launches(*reduce.KERNELS) == {"reduce_kernel": 1,
                                          "reduce_tail_kernel": 1}
    assert _n("walk_kernel") == _n("block_walk_kernel") == 2 * (
        tier == "walk")
    assert _n("csr_walk_kernel") == 2 * (tier == "csr")
    w_ids, w_pos, w_cnt = reduce.reduce_plain(res)
    assert cnt.dim() == 0 and cnt.dtype == torch.int32
    assert int(cnt) == int(w_cnt) > 0
    assert torch.equal(ids, w_ids) and torch.equal(pos, w_pos)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1000, 65536, 3_000_001])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_count_kernel_matches_plain(dev, n, offset):
    rng = np.random.default_rng(n + offset)
    r = torch.from_numpy(rng.integers(0, 3, size=n + offset,
                                      dtype=np.int32)).to(dev)[offset:]
    before = _n("count_kernel")
    got = count.count_nonzero(r)
    assert _n("count_kernel") == before + 1
    assert got.dim() == 0 and got.dtype == torch.int64
    assert int(got) == int(count.count_nonzero_plain(r)) == int(
        torch.count_nonzero(r))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_sharded_program_count(dev, k):
    # one program launch a call on one card, whatever the shards; the
    # count kernel once, equal to the plain count of the shards' results
    pats, rng = _ruleset(59)
    m = pt.Matcher(pats, device=dev)
    host = _corpus(rng, pats, 3 << 20)
    n = host.shape[0]
    data = torch.from_numpy(host).to(dev)
    sm = _sharded(m, dev, k)
    shards = sm._put(data, sm._shard_len(n))
    before, c_before = _n("program"), _n("count_kernel")
    res, cnt = sm.match_device(shards, n)
    assert _n("program") == before + 1 and _n("count_kernel") == c_before + 1
    assert int(cnt) == sum(int(count.count_nonzero_plain(r)) for r in res)
    assert torch.equal(torch.cat(res)[:n], m.match_device(data)[:n])


def test_program_span_holds_the_graph_launch_of_its_kernels(dev, tmp_path):
    # under torch.profiler: each call's pfac.program span holds one
    # cudaGraphLaunch, whose correlation id that call's sieve_smem_kernel
    # carries; nothing in a pfac.* span waits for the card or copies back
    from torch.profiler import ProfilerActivity, profile
    pats, rng = _ruleset(61)
    m = pt.Matcher(pats, device=dev)
    data = torch.from_numpy(_corpus(rng, pats, 1 << 20)).to(dev)
    m.match_device(data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            m.match_device(data)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("ph") == "X"]

    def inside(e, lo, hi):
        return lo <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= hi

    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in ev if str(e["name"]).startswith("pfac.")
             and e.get("cat") == "cpu_op"]
    progs = [(a, b) for a, b, nm in spans if nm == "pfac.program"]
    assert len(progs) == 3, spans
    runtime = [e for e in ev if e.get("cat") == "cuda_runtime"]
    k1 = [e for e in ev if e.get("cat") == "kernel"
          and "sieve_smem_kernel" in e["name"]]
    launches = []
    for lo, hi in progs:
        got = [e for e in runtime if e["name"] == "cudaGraphLaunch"
               and inside(e, lo, hi)]
        assert len(got) == 1, (lo, hi, [e["name"] for e in runtime
                                        if inside(e, lo, hi)])
        launches.append(got[0])
    # each K1 the profiler recorded carries the correlation id of the
    # graph launch in its own call's span, and starts after it
    by_corr = {e["args"]["correlation"]: e for e in launches}
    assert k1, "no sieve_smem_kernel recorded"
    for e in k1:
        c = e["args"].get("correlation")
        assert c in by_corr, (c, sorted(by_corr))
        assert float(e["ts"]) >= float(by_corr[c]["ts"])
    for lo, hi, nm in spans:
        waits = [e["name"] for e in runtime if inside(e, lo, hi) and (
            "Synchronize" in e["name"] or "Memcpy" in e["name"])]
        assert not waits, (nm, waits)


def test_device_counters_equal_a_host_recount(dev):
    # survivors and blocks escaped, added on the card by every program
    # call, equal a recount from K1's counts over the same calls; one
    # block of each dense corpus is all-match, so K3 takes it
    pats, rng = _ruleset(63)
    pats = pats + [b"\x07" * 4]
    m = pt.Matcher(pats, device=dev)
    eng = m._engine()
    block = eng.tile_rows * 128
    thresh = pipeline.threshold(eng._walk, block)
    inputs = []
    for n, dense in ((1 << 20, False), (300_001, True), (3 << 20, True)):
        host = _corpus(rng, pats, n)
        if dense:
            host[block:2 * block] = 7
        inputs.append(torch.from_numpy(host).to(dev))
    want_s = want_b = 0
    for d in inputs * 2:
        n = d.shape[0]
        _, _, counts = sieve.sieve(d, n, npad_for(n), eng._sieve)
        want_s += int(counts[counts < thresh].sum())
        want_b += int((counts >= thresh).sum())
    assert want_b == 4 and want_s > 0
    m.match_device(inputs[0])
    trace.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for d in inputs * 2:
            m.match_device(d)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = m.counters()
    assert (got["survivors"], got["blocks_escaped"]) == (want_s, want_b)
    assert got["positions"] == 2 * sum(npad_for(d.shape[0]) for d in inputs)
    assert got["launch.program"] == 6


def _k2_positions(eng, d):
    """The positions the program's compaction hands K2 for d, on the
    host's plain pieces."""
    n = d.shape[0]
    _, bits, counts = sieve.sieve_plain(d, n, npad_for(n), eng._sieve)
    return compact.compact_plain(bits, counts, pipeline.threshold(
        eng._walk, eng.tile_rows * 128))


@pytest.mark.parametrize("op", ["match_device", "match_reduce_device"])
def test_walk_counters_equal_a_host_recount(dev, op):
    # K2's walk steps, added on the card by every program call, equal the
    # plain walk's iterations (walk.walk_steps_plain) over the same
    # survivors: the cells' text and the virus-dense pattern stream, at
    # lengths that cut a block; the lane slots are whole warps' worth
    pats = rulesets.snort_like_patterns()
    m = pt.Matcher(pats, device=dev)
    eng = m._engine()
    rng = np.random.default_rng(29)
    inputs = [torch.from_numpy(h).to(dev) for h in (
        rulesets.planted_text(rng, pats, 3 << 20, 0.015),
        rulesets.pattern_stream(rng, pats, 1 << 20),
        rulesets.pattern_stream(rng, pats, 300_001))]
    want = sum(walk.walk_steps_plain(d, d.shape[0], _k2_positions(eng, d),
                                     eng._walk) for d in inputs)
    call = getattr(m, op)
    call(inputs[0])
    trace.reset()
    for d in inputs:
        call(d)
    c = m.counters()
    assert c["walk_steps"] == want > 0
    assert c["walk_slots"] % 32 == 0
    assert c["walk_steps"] <= c["walk_slots"] < 32 * c["walk_steps"]


@pytest.mark.parametrize("case", ["pattern_stream", "csr_all_match"])
def test_program_lists_the_survivors_in_order(dev, case, monkeypatch):
    # the program's compaction at the virus-dense cell's density (4 MiB of
    # the Snort-like set's patterns drawn and concatenated, ~4.7% of
    # positions survive) and with every position a survivor (b"aaaa" over
    # `a` on the CSR tier, escape disarmed): the result equals the plain
    # pipeline's, the survivors the plain compaction's count, the chunks
    # listed word by word a host recount, and K2's walk steps and lane
    # slots the recount over the plain compaction's list, which pins its
    # order
    n = 4 << 20
    if case == "pattern_stream":
        pats = rulesets.snort_like_patterns()
        host = rulesets.pattern_stream(np.random.default_rng(47), pats, n)
    else:
        monkeypatch.setattr(sieve_matcher, "build_walk_tables_gated",
                            lambda *a: None)
        pats, host = [b"aaaa"], np.full(n, ord("a"), np.uint8)
    m = pt.Matcher(pats, device=dev)
    eng = m._engine()
    assert (eng._walk is None) == (case == "csr_all_match")
    d = torch.from_numpy(host).to(dev)
    npad = npad_for(n)
    _, bits, counts = sieve.sieve_plain(d, n, npad, eng._sieve)
    thresh = pipeline.threshold(eng._walk, eng.tile_rows * 128)
    exact = compact.compact_plain(bits, counts, thresh)
    m.match_device(d)
    trace.reset()
    res = m.match_device(d)
    c = m.counters()
    assert torch.equal(res, pipeline.run(d, n, npad, eng._sieve, eng._walk,
                                         eng._csr, plain=True))
    assert c["survivors"] == exact.numel()
    wordwise = compact.wordwise_chunks_plain(bits, counts, thresh)
    assert c["compact_wordwise_chunks"] == wordwise
    if case == "csr_all_match":
        assert exact.numel() >= n - 3 and wordwise == n // 1024
        return
    assert 0.03 < exact.numel() / n < 0.07
    each = walk.walk_steps_each_plain(d, n, exact, eng._walk)
    assert c["walk_steps"] == int(each.sum())
    assert c["walk_slots"] == _slots_plain(each, walk.grid(eng._walk, dev))


def test_one_warp_of_survivors_spends_its_longest_walk(dev):
    # three long patterns in a byte that starts none: three survivors, one
    # warp, whose iterations are the longest of the three walks
    pats = rulesets.snort_like_patterns()
    m = pt.Matcher(pats, device=dev)
    eng = m._engine()
    quiet = next(c for c in range(256) if c not in {p[0] for p in pats})
    host = np.full(1 << 16, quiet, np.uint8)
    for off, p in zip((100, 5000, 40_000), sorted(pats, key=len)[-3:]):
        host[off:off + len(p)] = np.frombuffer(p, np.uint8)
    d = torch.from_numpy(host).to(dev)
    each = walk.walk_steps_each_plain(d, d.shape[0], _k2_positions(eng, d),
                                      eng._walk)
    assert each.numel() == 3 and int(each.min()) > 10
    m.match_device(d)
    trace.reset()
    m.match_device(d)
    c = m.counters()
    assert c["walk_steps"] == int(each.sum())
    assert c["walk_slots"] == 32 * int(each.max())


def test_the_walk_wrapper_counts_nothing(dev):
    # the per-kernel wrapper (and pipeline.run, made of wrappers) passes
    # null: the device's words move only with a program
    pats = rulesets.snort_like_patterns()
    m = pt.Matcher(pats, device=dev)
    eng = m._engine()
    d = torch.from_numpy(rulesets.pattern_stream(
        np.random.default_rng(31), pats, 1 << 20)).to(dev)
    n = d.shape[0]
    m.match_device(d)                   # the device's counter words exist
    trace.reset()
    match, bits, counts = sieve.sieve(d, n, npad_for(n), eng._sieve)
    pos, count = compact.compact(bits, counts, pipeline.threshold(
        eng._walk, eng.tile_rows * 128))
    walk.walk(d, n, pos, match, eng._walk, count)
    pipeline.run(d, n, npad_for(n), eng._sieve, eng._walk)
    assert _n("walk_kernel") == 2
    c = trace.device_counters()
    assert c["walk_steps"] == c["walk_slots"] == 0
    m.match_device(d)
    assert trace.device_counters()["walk_steps"] == walk.walk_steps_plain(
        d, n, _k2_positions(eng, d), eng._walk)


@pytest.mark.parametrize("corpus", ["virus_dense_worst", "text"])
@pytest.mark.parametrize("plan", ["whole", "split"])
def test_k2_image_whole_and_split(dev, plan, corpus):
    # K2 in both instantiations, by the ruleset and no switch: the
    # Snort-like set's walk tables fit shared memory whole, the F1 set's
    # do not (their entry table alone is resident). On 8 MB of the set's own
    # patterns concatenated and on text with 1.5% planted copies: K2
    # through its wrapper and inside a program equals the plain walk, its
    # walk steps equal the host's recount, and every program call counts
    # as whole or split by the plan
    pats = (rulesets.snort_like_patterns() if plan == "whole"
            else _f1_patterns())
    m = pt.Matcher(pats, device=dev)
    eng = m._engine()
    resident = walk.launch_plan(eng._walk, dev)[1]
    words = eng._walk.arena.numel()
    assert (resident == words) == (plan == "whole") and resident > 0
    rng = np.random.default_rng(37)
    n = (8 << 20) - 5
    host = (rulesets.pattern_stream(rng, pats, n)
            if corpus == "virus_dense_worst"
            else rulesets.planted_text(rng, pats, n, 0.015))
    d = torch.from_numpy(host).to(dev)
    npad = npad_for(n)
    match, bits, counts = sieve.sieve(d, n, npad, eng._sieve)
    thresh = pipeline.threshold(eng._walk, eng.tile_rows * 128)
    pos, cnt = compact.compact(bits, counts, thresh)
    exact = compact.compact_plain(bits, counts, thresh)
    # the pattern stream: enough survivors that every CTA stages what its
    # plan holds (kStageMin = 256 a CTA in csrc/walk.cu); the text: a few
    # thousand, so a CTA stages split tables' prefix not at all
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (exact.numel() >= 256 * sms) == (corpus == "virus_dense_worst")
    assert exact.numel() > 1000
    out_k, out_p = match.clone(), match.clone()
    walk.walk(d, n, pos, out_k, eng._walk, cnt)
    walk.walk_plain(d, n, exact, out_p, eng._walk)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p) and not torch.equal(out_k, match)
    m.match_device(d)
    trace.reset()
    calls = 3
    for _ in range(calls):
        res = m.match_device(d)
    c = m.counters()
    assert torch.equal(res, pipeline.run(d, n, npad, eng._sieve, eng._walk,
                                         plain=True))
    assert c["walk_steps"] == calls * walk.walk_steps_plain(d, n, exact,
                                                            eng._walk)
    assert c["walk_slots"] % 32 == 0
    assert c["walk_steps"] <= c["walk_slots"] < 32 * c["walk_steps"]
    key, other = (("walk.whole_calls", "walk.split_calls") if plan == "whole"
                  else ("walk.split_calls", "walk.whole_calls"))
    assert c[key] == c["launch.program"] == calls and c[other] == 0


def _slots_plain(each: torch.Tensor, grid: int) -> int:
    """K2's ``walk_slots`` for survivors that take ``each`` loop iterations,
    recounted from csrc/walk.cu's dealing: runs of 32 consecutive survivors
    round robin over min(grid, runs) CTAs of 1,024 lanes, a CTA's j-th run
    in its warp j % 32, survivor i in lane i % 32 of it; a warp spends 32
    slots an iteration of its busiest lane."""
    total = each.numel()
    if total == 0:
        return 0
    runs = -(-total // 32)
    ctas = min(grid, runs)
    i = torch.arange(total)
    r = i // 32
    lane = (r % ctas) * 1024 + (r // ctas) % 32 * 32 + i % 32
    sums = torch.zeros(ctas * 1024, dtype=torch.int64).index_add_(
        0, lane, each.cpu())
    return 32 * int(sums.view(-1, 32).max(1).values.sum())


@pytest.mark.parametrize("case", ["virus_dense_worst", "pattern_stream_64MB",
                                  "defcon_like", "f1_split", "unaligned"])
def test_k2_records_equal_the_plain_walk(dev, case):
    # K2 reads a loop iteration's three probes from its record: through its
    # wrapper and inside a program it equals the plain walk (which reads
    # the descriptor rows) on the Snort-like set's own patterns
    # concatenated (8 and 64 MiB), on text with 1.5% planted copies, on the
    # F1 set's split tables (walk_kernel<false>) and on a view 3 bytes in;
    # the program's walk steps and lane slots equal a host recount
    pats = _f1_patterns() if case == "f1_split" else \
        rulesets.snort_like_patterns()
    m = pt.Matcher(pats, device=dev)
    eng = m._engine()
    resident = walk.launch_plan(eng._walk, dev)[1]
    assert (resident < eng._walk.arena.numel()) == (case == "f1_split")
    rng = np.random.default_rng(43)
    n = {"pattern_stream_64MB": 64 << 20, "defcon_like": 32 << 20}.get(
        case, 8 << 20)
    offset = 3 if case == "unaligned" else 0
    host = (rulesets.planted_text(rng, pats, n + offset, 0.015)
            if case == "defcon_like"
            else rulesets.pattern_stream(rng, pats, n + offset))
    d = torch.from_numpy(host).to(dev)[offset:]
    npad = npad_for(n)
    match, bits, counts = sieve.sieve(d, n, npad, eng._sieve)
    thresh = pipeline.threshold(eng._walk, eng.tile_rows * 128)
    pos, cnt = compact.compact(bits, counts, thresh)
    exact = compact.compact_plain(bits, counts, thresh)
    assert torch.equal(pos[:int(cnt)], exact) and exact.numel() > 1000
    out_k, out_p = match.clone(), match.clone()
    walk.walk(d, n, pos, out_k, eng._walk, cnt)
    walk.walk_plain(d, n, exact, out_p, eng._walk)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p) and not torch.equal(out_k, match)
    m.match_device(d)
    trace.reset()
    res = m.match_device(d)
    c = m.counters()
    assert torch.equal(res, pipeline.run(d, n, npad, eng._sieve, eng._walk,
                                         plain=True))
    each = walk.walk_steps_each_plain(d, n, exact, eng._walk)
    assert c["walk_steps"] == int(each.sum())
    assert c["walk_slots"] == _slots_plain(each, walk.grid(eng._walk, dev))


def test_a_new_length_builds_one_program(dev):
    pats, rng = _ruleset(65)
    m = pt.Matcher(pats, device=dev)
    data = torch.from_numpy(_corpus(rng, pats, 3 << 20)).to(dev)

    def built():
        return trace.counters()["build.programs"]

    for n, more in ((1 << 20, 1), (1 << 20, 0), (3 << 20, 1), (1 << 20, 0),
                    ((1 << 20) - 5, 0)):            # the same npad
        before = built()
        m.match_device(data[:n])
        assert built() == before + more, n
    before = built()
    m.match_reduce_device(data[:1 << 20])           # the reduce's own
    assert built() == before + 1
    assert trace.counters()["build.program_s"] > 0


def _k3_cases():
    """(name, patterns, host bytes, view offset) for K3's counters: all-match
    (a view too), dense blocks of 'a' with the last one cut by n, and the
    Snort-scale set, whose walk tables K3 holds only in part."""
    snort = rulesets.snort_like_patterns() + [b"zzzz", b"zzzzzzzz"]
    cut = _dense_corpus(3 * 65536 + 3 * 8192 + 3)
    cut[3 * 65536:] = ord("a")          # the last block dense, cut by n
    return [("all_match", [b"aaaa"], np.full(3 * 65536 + 1111, ord("a"),
                                             np.uint8), 0),
            ("all_match_view", [b"aaaa"], np.full(3 * 65536 + 1114,
                                                  ord("a"), np.uint8), 3),
            ("dense_cut", [b"aaaa", b"aaaab", b"a" * 40, b"ab", b"a",
                           b"aaab" * 5], cut, 0),
            ("snort_mixed", snort, rulesets.mixed_density(
                np.random.default_rng(5), snort, (4 << 20) + 12345,
                sieve.BLOCK), 0)]


@pytest.mark.parametrize("case", [c[0] for c in _k3_cases()])
def test_block_walk_counters_equal_a_host_recount(dev, case):
    # K3's probes and positions, added on the card by every program call,
    # equal the host's recount (block_walk.block_walk_probes_plain) and the
    # escaped blocks' positions below n; the per-kernel wrapper adds none
    _, pats, host, offset = next(c for c in _k3_cases() if c[0] == case)
    m = pt.Matcher(pats, device=dev)
    eng = m._engine()
    d = torch.from_numpy(host).to(dev)[offset:]
    n = d.shape[0]
    npad, block = npad_for(n), sieve.BLOCK
    _, _, counts = sieve.sieve(d, n, npad, eng._sieve)
    dense = block_walk._dense(counts, block).tolist()
    escaped = block_walk.escaped_blocks(counts, npad)
    walked = sum(min(block, n - b * block) for b in dense)
    probes = block_walk.block_walk_probes_plain(d, n, counts, eng._walk, block)
    assert escaped == len(dense) >= 1 and probes >= walked > 0
    if case.startswith("all_match"):
        assert walked == escaped * block == 3 * block and probes == walked
    if case == "dense_cut":
        assert dense[-1] == 3 and walked == 65536 + 3 * 8192 + 3
    m.match_device(d)
    trace.reset()
    calls = 2
    for _ in range(calls):
        res = m.match_device(d)
    c = m.counters()
    assert torch.equal(res, pipeline.run(d, n, npad, eng._sieve, eng._walk,
                                         plain=True))
    assert c["blocks_escaped"] == calls * escaped
    assert c["block_walk_positions"] == calls * walked
    assert c["block_walk_positions"] <= c["blocks_escaped"] * block
    assert c["block_walk_probes"] == calls * probes
    match, _, counts = sieve.sieve(d, n, npad, eng._sieve)
    block_walk.block_walk(d, n, counts, match, eng._walk)
    after = m.counters()
    assert (after["block_walk_probes"], after["block_walk_positions"]) == (
        c["block_walk_probes"], c["block_walk_positions"])


def test_block_walk_counters_stay_zero_without_a_dense_block(dev):
    # the text cells' traffic: K3 launches in every program call, finds no
    # dense block and adds nothing, while the compaction counts survivors
    pats = rulesets.snort_like_patterns()
    m = pt.Matcher(pats, device=dev)
    d = torch.from_numpy(rulesets.planted_text(
        np.random.default_rng(41), pats, 3 << 20, 0.015)).to(dev)
    m.match_device(d)
    trace.reset()
    m.match_device(d)
    c = m.counters()
    assert c["launch.block_walk_kernel"] == 1 and c["blocks_escaped"] == 0
    assert c["survivors"] > 0 and c["walk_steps"] > 0
    assert c["block_walk_probes"] == c["block_walk_positions"] == 0

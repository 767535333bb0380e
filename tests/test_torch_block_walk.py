"""K3's host side on the CPU, bit-exact (tolerance 0): the tile-wise plain
walk (what the kernel does: each dense tile walked alone from its slice of
``CHUNK + lookahead`` bytes) against the whole-corpus plain walk, the golden
model and the reference's ``SieveMatcher(interpret=True)``; the rule that
sizes the shared-memory resident part of the walk tables; and G2's path
rule."""
import numpy as np
import pytest
import torch

import pfac_tpu.backends.pallas_sieve as S
import pfac_tpu_torch as pt
from pfac_tpu.backends import golden
from pfac_tpu_torch.backends import block_walk, compact, sieve, walk
from pfac_tpu_torch.backends.sieve_matcher import npad_for
from pfac_tpu_torch.experiments import (axis0_gather_probe, gathers,
                                        lanegather2_micro, lanegather_micro,
                                        rulesets)

CHUNK = block_walk.CHUNK


def _tiles_result(m, data: bytes, n: int, block: int):
    """The pipeline with K3 tile-wise: sieve, the tile-wise plain walk of the
    dense blocks, compaction and K2's plain walk of the rest -> (result[:n],
    tiles walked). Also holds the tile-wise walk equal to the whole-corpus
    plain walk."""
    eng = m._engine()
    t = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    npad = -(-max(n, 1) // block) * block
    base, bits, counts = sieve.sieve(t, n, npad, eng._sieve, block)
    whole, tiled = base.clone(), base.clone()
    block_walk.block_walk_plain(t, n, counts, whole, eng._walk)
    block_walk.block_walk_tiles_plain(t, n, counts, tiled, eng._walk)
    assert torch.equal(whole, tiled)
    pos, count = compact.compact(bits, counts,
                                 block // block_walk.DENSE_ESCAPE_DIV)
    walk.walk(t, n, pos, tiled, eng._walk, count)
    assert not tiled[n:].any()
    return tiled[:n].numpy(), len(block_walk.dense_tiles(n, counts, block))


def _check(pats, data: bytes, n: int | None = None, block: int = CHUNK,
           reference: bool = True) -> int:
    n = len(data) if n is None else n
    m = pt.Matcher(pats, device="cpu", tile=CHUNK)
    got, tiles = _tiles_result(m, data, n, block)
    assert got.tolist() == golden.match_edges_batch(m.automaton,
                                                    data[:n]).tolist()
    if reference:
        ref = S.SieveMatcher(m.automaton, interpret=True)
        assert got.tolist() == np.asarray(ref.match(data[:n])).tolist()
    return tiles


def test_tiles_all_match():
    assert _check([b"aaaa"], b"a" * (3 * CHUNK + 1111)) == 3


def _mixed():
    rng = np.random.default_rng(3)
    pats = [bytes(rng.integers(0, 256, size=int(k), dtype=np.uint8))
            for k in list(rng.integers(1, 4, size=10))
            + list(rng.integers(4, 30, size=60))]
    pats = list(dict.fromkeys(pats)) + [b"zzzz", b"zzzzzzzz"]
    n = 3 * CHUNK + 1111
    d = rng.integers(0, 256, size=n, dtype=np.uint8)
    d[CHUNK:2 * CHUNK] = ord("z")
    for i in range(0, n - 40, 177):
        p = pats[int(rng.integers(0, len(pats)))]
        d[i:i + len(p)] = np.frombuffer(p, np.uint8)
    return pats, d.tobytes()


def test_tiles_mixed_density():
    pats, data = _mixed()
    assert _check(pats, data) == 1


def test_tiles_boundary_straddle():
    # a 40-byte match that starts in the dense tile and ends in the next
    d = np.zeros(2 * CHUNK, np.uint8)
    d[:CHUNK + 60] = ord("z")
    assert _check([b"z" * 40], d.tobytes()) == 1


def test_tiles_long_patterns():
    # matches of ~1 KB that run far into the next tile: the lookahead grows
    # with the walk's depth (the reference does not arm its escape here)
    pats = [b"z" * 1000 + b"y", b"zzzz", b"z" * 600 + b"y"]
    d = bytearray(b"z" * (CHUNK + 500) + b"y" + bytes(3000))
    d[5000:5001] = b"y"
    m = pt.Matcher(pats, device="cpu", tile=CHUNK)
    nsteps = block_walk.steps_of(m._engine()._walk)
    assert block_walk.lookahead(nsteps) >= 1001
    assert _check(pats, bytes(d), reference=False) == 1


@pytest.mark.parametrize("cut", [1, 3, 4])
@pytest.mark.parametrize("block", [2 * CHUNK, 8 * CHUNK])
def test_tiles_n_cuts_last_dense_block(cut, block):
    # n ends `cut` bytes into a tile of a dense block: that tile has `cut`
    # positions, and the tile before it reads its lookahead up to n only
    pats = [b"aaaa", b"aaaaaa", b"a" * 9, b"a" * 10 + b"b", b"ab"]
    n = block + block // 2 + cut
    data = b"a" * (n + 300)              # bytes at and past n must not count
    tiles = _check(pats, data, n=n, block=block,
                   reference=(block == 2 * CHUNK))
    assert tiles == (block + block // 2) // CHUNK + 1


@pytest.mark.parametrize("nsteps", [0, 1, 6, 47, 499])
def test_lookahead_arithmetic(nsteps):
    # the entry key's 4 bytes and 2 a step, rounded up to the bulk copy's 16
    look = block_walk.lookahead(nsteps)
    assert look % 16 == 0 and 0 <= look - (4 + 2 * nsteps) < 16


def _snort_walk():
    return pt.Matcher(rulesets.snort_like_patterns(),
                      device="cpu")._engine()._walk


def test_resident_words_prefix_on_table_boundary():
    tabs = _snort_walk()
    ends = block_walk.table_ends(tabs)
    assert ends == sorted(ends) and ends[-1] == tabs.arena.numel()
    assert len(ends) == sum(r[6] for r in tabs.rows)
    for budget in (4 * ends[1], 4 * ends[1] + 3, 100_000, 177_824,
                   4 * ends[-1] - 4, 4 * ends[-1], 1 << 20):
        r = block_walk.resident_words(tabs, budget)
        assert r in ends and 4 * r <= budget
        nxt = [e for e in ends if e > r]
        assert not nxt or 4 * nxt[0] > budget        # the longest such prefix
    assert block_walk.resident_words(tabs, 1 << 20) == tabs.arena.numel()


def test_resident_words_whole_arena_for_aaaa():
    tabs = pt.Matcher([b"aaaa"], device="cpu")._engine()._walk
    nsteps = block_walk.steps_of(tabs)
    budget = sieve.SMEM_LIMIT - block_walk.fixed_smem_bytes(
        nsteps, block_walk.tile_cap(npad_for(128 << 20) // CHUNK, 132))
    assert block_walk.resident_words(tabs, budget) == tabs.arena.numel()


def test_resident_words_raises_when_entry_does_not_fit():
    # the prefix shrinks table by table to the entry table, then to none;
    # the kernels read the rest through L1/L2
    tabs = _snort_walk()
    ends = block_walk.table_ends(tabs)
    entry_end = ends[1]                             # entry and entry_final
    assert block_walk.resident_words(tabs, 4 * entry_end) == entry_end
    assert block_walk.resident_words(tabs, 4 * entry_end - 1) == ends[0]
    assert block_walk.resident_words(tabs, 4 * ends[0]) == ends[0]
    for budget in (4 * ends[0] - 1, 4, 3, 0):
        assert block_walk.resident_words(tabs, budget) == 0
    with pytest.raises(ValueError, match="negative"):
        block_walk.resident_words(tabs, -5000)      # the fixed part does not fit


def _f1_patterns(extra=()):
    """The ruleset of ROADMAP.md's fault F1: 17,000 random 6-byte patterns
    (seed 17000), on the walk-table tier, whose entry table alone outgrows
    the shared memory K3 has for tables (K2, with more room, keeps it)."""
    rng = np.random.default_rng(17000)
    return [bytes(rng.integers(0, 256, size=6, dtype=np.uint8))
            for _ in range(17000)] + list(extra)


def test_f1_plans_fit_on_132_sms(monkeypatch):
    # K3's and K2's plans at 128 MB on a 132-SM card over the one layout
    # of the walk tables: nothing resident for K3, every table read through
    # L1/L2, and no raise; K2 keeps the entry table alone
    eng = pt.Matcher(_f1_patterns(), device="cpu")._engine()
    tabs = eng._walk
    assert tabs is not None and eng.walk_tables.vmem_bytes <= 6 << 20
    nsteps = block_walk.steps_of(tabs)
    ntiles = npad_for(128 << 20) // CHUNK
    entry = 4 * block_walk.table_ends(tabs)[0]
    assert sieve.SMEM_LIMIT - block_walk.fixed_smem_bytes(
        nsteps, block_walk.tile_cap(ntiles, 132)) < entry
    assert entry <= sieve.SMEM_LIMIT - walk.fixed_smem_bytes(nsteps)

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    dev = torch.device("cuda", 0)
    k3 = block_walk.launch_plan(tabs, ntiles, dev)
    assert k3 == (nsteps, block_walk.lookahead(nsteps),
                  block_walk.tile_cap(ntiles, 132), 0)
    assert block_walk.fixed_smem_bytes(nsteps, k3[2]) <= sieve.SMEM_LIMIT
    k2 = walk.launch_plan(tabs, dev)
    assert k2 == (nsteps, walk.table_ends(tabs)[0])
    assert walk.fixed_smem_bytes(nsteps) + 4 * k2[1] <= sieve.SMEM_LIMIT


def test_f1_ruleset_vs_golden():
    # the F1 ruleset (and zzzz, for a dense block) on 64 KB with planted
    # patterns: the port's CPU match against the reference's golden model
    pats = _f1_patterns([b"zzzz", b"zzzzzzzz"])
    rng = np.random.default_rng(3)
    d = rng.integers(0, 256, size=1 << 16, dtype=np.uint8)
    d[2 * CHUNK:3 * CHUNK] = ord("z")
    for off in range(0, d.shape[0] - 8, 97):
        p = pats[int(rng.integers(0, len(pats)))]
        d[off:off + len(p)] = np.frombuffer(p, np.uint8)
    m = pt.Matcher(pats, device="cpu", tile=CHUNK)
    eng = m._engine()
    assert eng._walk is not None
    got = m.match(d.tobytes())
    assert got.tolist() == golden.match_edges_batch(m.automaton,
                                                    d.tobytes()).tolist()
    assert (got > 0).sum() > 600
    _, _, counts = sieve.sieve(torch.from_numpy(d), d.shape[0], 1 << 16,
                               eng._sieve, CHUNK)
    assert block_walk.escaped_blocks(counts, 1 << 16) == 1


def test_tier_gate_keeps_k3_within_shared_memory():
    # K3's lookahead and descriptor rows grow with the deepest pattern; the
    # walk tables' 6 MB tier gate stops before they outgrow a CTA's shared
    # memory, so the escape is armed wherever the walk tier is taken
    tabs = pt.Matcher([b"z" * 1500 + b"y", b"zzzz"],
                      device="cpu")._engine()._walk
    nsteps = block_walk.steps_of(tabs)
    assert nsteps >= 748
    fixed = block_walk.fixed_smem_bytes(nsteps, 2048)   # 2^31 positions
    assert block_walk.resident_words(tabs, sieve.SMEM_LIMIT - fixed) > 0
    assert fixed < sieve.SMEM_LIMIT // 2 + 25_000
    eng = pt.Matcher([b"z" * 2000 + b"y", b"zzzz"], device="cpu")._engine()
    assert eng._walk is None and eng._csr is not None


def test_snort_budget_on_132_sms():
    # the Snort walk tables at 128 MB on a 132-SM card: most of them
    # resident (89%), everything within a CTA's shared memory
    tabs = _snort_walk()
    nsteps = block_walk.steps_of(tabs)
    cap = block_walk.tile_cap(npad_for(128 << 20) // CHUNK, 132)
    assert cap % 4 == 0 and cap * 132 >= npad_for(128 << 20) // CHUNK
    fixed = block_walk.fixed_smem_bytes(nsteps, cap)
    r = block_walk.resident_words(tabs, sieve.SMEM_LIMIT - fixed)
    assert fixed + 4 * r <= sieve.SMEM_LIMIT
    assert 0.5 < r / tabs.arena.numel() < 1.0


@pytest.mark.parametrize("rows,cols,m,k,axis,path", [
    (512, 128, 8, 128, 0, "direct"),          # E5 a
    (512, 128, 512, 128, 0, "staged"),        # E5 b
    (32, 128, 8, 128, 0, "direct"),           # E5 c: on the rule's edge
    (8, 128, 8, 128, 1, "direct"),            # E6's check: on the edge
    (8, 128, 131072, 128, 1, "staged"),       # E1-A
    (32, 128, 9, 128, 0, "staged"),
    (8, 128, 16, 128, 1, "staged")])
def test_tile_path_rule(rows, cols, m, k, axis, path):
    assert gathers.tile_path(rows, cols, m, k, axis) == path


def test_tile_path_of_the_micro_benchmark_cases(monkeypatch):
    # the rule applied to the tensors the E5, E6 and E1-A cases really pass
    dev = torch.device("cpu")
    seen = {}
    real = gathers.tile_gather

    def spy(tile, idx, axis, path=None):
        seen[name] = gathers.tile_path(*tile.shape, *idx.shape, axis)
        return real(tile, idx, axis, path)

    monkeypatch.setattr(gathers, "tile_gather", spy)
    for case in list(axis0_gather_probe.cases(dev)) + [
            lanegather2_micro.case_lane_gather_correct(dev),
            lanegather_micro.case_lane_gather(dev, n_idx=1 << 14)]:
        name = case.name.split()[1]
        case.run()
    assert seen == {"a_axis0_8from512": "direct",
                    "b_axis0_512from512": "staged",
                    "c_axis0_8from32": "direct", "lane-gather": "direct",
                    "A": "staged"}


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("extra", [0, 1])
def test_tile_gather_both_sides_of_the_edge(axis, extra):
    # the most lookups the direct path takes, and one index row more
    rng = np.random.default_rng(axis + 2 * extra)
    rows, cols = (32, 128) if axis == 0 else (8, 128)
    m = 8 + 8 * extra
    tile = rng.integers(0, 1 << 30, size=(rows, cols)).astype(np.int32)
    idx = rng.integers(0, rows if axis == 0 else cols,
                       size=(m, cols)).astype(np.int32)
    assert gathers.tile_path(rows, cols, m, cols, axis) == (
        "staged" if extra else "direct")
    want = np.take_along_axis(np.tile(tile, (m // rows, 1)) if axis else tile,
                              idx, axis=axis)
    for path in (None, "direct", "staged"):
        got = gathers.tile_gather(torch.from_numpy(tile),
                                  torch.from_numpy(idx), axis, path)
        assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="path"):
        gathers.tile_gather(torch.from_numpy(tile), torch.from_numpy(idx),
                            axis, "smem")

"""The gather micro-benchmarks of the port (``pfac_tpu_torch.experiments``)
against the reference's Pallas kernels in ``experiments/*.py``, bit-exact
(tolerance 0), at small sizes on the CPU.

The reference scripts are loaded by file path and their kernels run in
interpret mode (``pallas_call`` wrapped with ``interpret=True``). Their
outputs and operands are captured through the scripts' own helpers
(``bench``, ``try_case``, ``run_variant``); on CPU tensors the port's
wrappers run their plain versions.
"""
import functools
import importlib.util
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

import pfac_tpu_torch as pt
from pfac_tpu_torch import trace
from pfac_tpu_torch.backends import sieve_matcher
from pfac_tpu_torch.experiments import (align_micro, axis0_gather_probe,
                                        dyngather_micro, gather_micro,
                                        gathers, harness, lanegather2_micro,
                                        lanegather_micro)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PALLAS_CALL = pallas.pallas_call


def _load(name: str):
    """A reference script as a module; its import-time change of the
    compilation-cache directory is undone."""
    cache = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "experiments", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax.config.update("jax_compilation_cache_dir", cache)
    return mod


@pytest.fixture
def ref(monkeypatch):
    """-> load(name): the reference script with its Pallas kernels in
    interpret mode and `bench` capturing (operands, output) into
    `mod.seen`, one run each."""
    monkeypatch.setattr(pallas, "pallas_call",
                        functools.partial(_PALLAS_CALL, interpret=True))

    def load(name):
        mod = _load(name)
        mod.seen = []

        def bench(fn, *args, iters=0):
            out = fn(*args)
            mod.seen.append(([np.asarray(a) for a in args], np.asarray(out)))
            return 1.0, out

        mod.bench = bench
        return mod
    return load


def _only(items):
    """The plain outputs of a port case's placements (all equal)."""
    outs = []
    for item in items:
        if isinstance(item, harness.Case):
            assert harness.check(item) == 0
            outs.append(item.run().numpy())
    assert outs and all(np.array_equal(o, outs[0]) for o in outs)
    return outs[0]


def test_e1_lane_gather(ref):
    mod = ref("lanegather_micro")
    _, ok, _ = mod.case_lane_gather(n_idx=16 * 128, tile_rows=8)
    (tab, idx), out = mod.seen[0]
    case = lanegather_micro.case_lane_gather("cpu", n_idx=16 * 128)
    assert harness.check(case) == 0
    assert np.array_equal(case.run().numpy(), out)
    assert np.array_equal(case.expect, out)
    assert not ok                    # the reference's own check is wrong


def test_e1_lane_gather_oracle(ref):
    # the kernel reads row i & 7: its output is take_along_axis over the
    # tiled table, not over the repeated rows the reference's check builds
    mod = ref("lanegather_micro")
    mod.case_lane_gather(n_idx=16 * 128, tile_rows=8)
    (tab, idx), out = mod.seen[0]
    tiled = np.take_along_axis(np.tile(tab, (2, 1)), idx, axis=1)
    repeated = np.take_along_axis(
        np.broadcast_to(tab[:, None, :], (8, 2, 128)).reshape(-1, 128),
        idx, axis=1)
    assert np.array_equal(out, tiled)
    assert not np.array_equal(out, repeated)
    got = gathers.tile_gather(torch.tensor(tab), torch.tensor(idx), 1)
    assert np.array_equal(got.numpy(), tiled)


@pytest.mark.parametrize("case", ["case_composite", "case_plane_scan"])
def test_e1_word_lookup(ref, case):
    mod = ref("lanegather_micro")
    getattr(mod, case)(2048, n_idx=2048, tile_rows=8)
    (_, idx), out = mod.seen[0]
    port = list(lanegather_micro.case_word_lookup(2048, "cpu", n_idx=2048))
    # every placement forced, then the one the wrapper picks by itself
    # (2,048 lookups into 2,048 words: no more than it would stage, so L1)
    assert [c.name.split()[-1] for c in port] == [*gathers.PLACEMENTS,
                                                  "(ldg)"]
    assert np.array_equal(_only(port), out)


@pytest.mark.parametrize("case", ["try_take_flat", "try_take_2d",
                                  "try_xla_take_baseline"])
def test_e2_pair_table(ref, case):
    mod = ref("gather_micro")
    assert getattr(mod, case)()[1]
    (table, idx), out = mod.seen[0]
    # the XLA baseline makes take_flat's lookups: the port's plain version
    port = (gather_micro.case_take_2d if case == "try_take_2d"
            else gather_micro.case_take_flat)
    items = list(port("cpu"))
    # 266,240 B: too large for one CTA's shared memory, so smem refuses;
    # 8K lookups are fewer than a CTA would stage, so G1 reads it by L1
    assert isinstance(items[0], harness.Refusal)
    assert "shared memory" in harness.refuse(items[0])
    assert items[-1].name.endswith("default (ldg)")
    assert gathers.word_placement(table.size) == "prefix"
    got = _only(items)
    if case == "try_xla_take_baseline":
        got = items[1].plain().numpy()
    assert table.size == gather_micro.TABLE_PAD
    assert np.array_equal(got, out)


@pytest.mark.parametrize("chain", [1, 4])
def test_e3_dyngather(ref, chain):
    mod = ref("dyngather_micro")
    assert mod.run_case(264, 2048, 8, chain=chain)[1]
    (_, idx), out = mod.seen[0]
    port = list(dyngather_micro.case_chain(264, "cpu", n_idx=2048,
                                           chain=chain))
    assert [c.name.split()[-1] for c in port] == ["smem", "ldg"]
    assert port[0].lookups == 2048 * chain
    assert np.array_equal(_only(port), out)


def test_e4_align(ref):
    mod = ref("align_micro")
    case = align_micro.case_align("cpu", survivors=2048)
    rng = np.random.default_rng(0)
    pos2d = rng.integers(0, 1 << 26, size=(16, 128)).astype(np.int32)
    raw = rng.integers(-(1 << 31), 1 << 31, size=(2 * mod.W_RAW * 8, 128),
                       dtype=np.int64).astype(np.int32)
    assert harness.check(case) == 0
    got = case.run().numpy()
    for variant in ("base", "tree"):
        _, out = mod.run_variant(variant, jnp.asarray(pos2d),
                                 jnp.asarray(raw), 2)
        assert np.array_equal(got, np.asarray(out))


def test_e5_axis0(ref, monkeypatch):
    mod = ref("axis0_gather_probe")
    seen = {}

    def try_case(name, kernel, out_shape, *args):
        seen[name] = np.asarray(jax.jit(lambda *a: pallas.pallas_call(
            kernel, out_shape=out_shape)(*a))(*args))

    monkeypatch.setattr(mod, "try_case", try_case)
    mod.main()
    port = list(axis0_gather_probe.cases("cpu"))
    assert [c.name.split()[-1] for c in port] == list(seen)
    for c in port:
        assert harness.check(c) == 0
        assert np.array_equal(c.run().numpy(), seen[c.name.split()[-1]])


def test_e6_lane_gather_semantics(ref):
    mod = ref("lanegather2_micro")
    assert mod.case_lane_gather_correct()
    case = lanegather2_micro.case_lane_gather_correct("cpu")
    assert harness.check(case) == 0


@pytest.mark.parametrize("w", [128, 1024])
def test_e6_planes(ref, w):
    mod = ref("lanegather2_micro")
    mod.case_planes(w, n_idx=2048, tile_rows=8)
    (planes, idx), out = mod.seen[0]
    port = list(lanegather2_micro.case_planes(w, "cpu", n_idx=2048))
    assert np.array_equal(_only(port), out)
    # the reference's planes hold the port's flat table, sublane-replicated
    flat = planes.reshape(-1, 8, 128)[:, 0, :].reshape(-1)[:w]
    assert np.array_equal(gathers.word_gather_plain(
        torch.tensor(flat), torch.tensor(idx)).numpy(), out)


def test_smem_refuses_oversized_tables():
    idx = torch.zeros(4, dtype=torch.int32)
    fits = torch.arange(gathers.SMEM_WORDS, dtype=torch.int32)
    over = torch.arange(gathers.SMEM_WORDS + 1, dtype=torch.int32)
    assert gathers.word_gather(fits, idx, "smem").tolist() == [0] * 4
    assert gathers.chain_gather(fits, idx, 2, "smem").tolist() == [0] * 4
    for call in (lambda: gathers.word_gather(over, idx, "smem"),
                 lambda: gathers.chain_gather(over, idx, 1, "smem")):
        with pytest.raises(ValueError, match="58112 words"):
            call()
    assert gathers.word_gather(over, idx, "ldg").tolist() == [0] * 4
    # G2's staged path holds the tile (axis 1) or its 32-column strips
    # (axis 0); few lookups take the direct path, which stages nothing
    wide = torch.zeros(8, 7265, dtype=torch.int32)
    tall = torch.zeros(1817, 4, dtype=torch.int32)
    few = torch.zeros(8, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        gathers.tile_gather(wide, torch.zeros(800, 128, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="shared memory"):
        gathers.tile_gather(tall, torch.zeros(14540, 4, dtype=torch.int32), 0)
    for tile, axis in ((wide, 1), (tall, 0)):
        with pytest.raises(ValueError, match="shared memory"):
            gathers.tile_gather(tile, few, axis, path="staged")
        assert gathers.tile_gather(tile, few, axis).shape == few.shape


@pytest.mark.parametrize("words,placement", [
    (gathers.SMEM_WORDS, "smem"), (gathers.SMEM_WORDS + 1, "prefix"),
    (gathers.PREFIX_WORDS, "prefix"), (gathers.PREFIX_WORDS + 1, "ldg")])
def test_word_placement_rule(words, placement):
    # one CTA's shared memory, then a prefix of the table there and the
    # rest through L1, then L1 alone; the cluster only when forced
    assert gathers.word_placement(words) == placement
    assert gathers.word_placement(words, 16 << 20) == placement
    # no more lookups than a CTA would stage: L1, staging nothing
    assert gathers.word_placement(words, min(words, gathers.SMEM_WORDS)) == \
        "ldg"
    assert gathers.word_kernel(words) == "word_gather_kernel"
    assert (gathers.word_kernel(words, "cluster")
            == "word_gather_cluster_kernel")
    idx = torch.tensor([0, words - 1, words // 2], dtype=torch.int32)
    table = torch.arange(words, dtype=torch.int32)
    assert gathers.word_gather(table, idx).tolist() == idx.tolist()
    if words <= gathers.CLUSTER_WORDS:
        ranks = 2 if words <= 2 * gathers.SMEM_WORDS else 4
        assert gathers.cluster_ranks(words) == ranks
        assert gathers.word_gather(table, idx, "cluster").tolist() == \
            idx.tolist()


@pytest.mark.parametrize("words", [7, 1000, gathers.SMEM_WORDS + 1,
                                   gather_micro.TABLE_PAD,
                                   2 * gathers.SMEM_WORDS + 3,
                                   gathers.CLUSTER_WORDS])
def test_cluster_split_equals_take(words):
    # which CTA of the cluster holds word w, at which offset: contiguous
    # parts of ceil(words / ranks), every word in exactly one part
    rng = np.random.default_rng(words)
    table = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=words,
                                          dtype=np.int64).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, words, size=5000).astype(np.int32))
    ranks = gathers.cluster_ranks(words)
    part = -(-words // ranks)
    assert part <= gathers.SMEM_WORDS
    rank, off = gathers.cluster_home(torch.arange(words), words)
    assert rank.max() < ranks and off.max() < part
    assert torch.equal(rank * part + off, torch.arange(words))
    got = gathers.word_gather_cluster_plain(table, idx)
    assert torch.equal(got, table[idx.long()])
    assert torch.equal(gathers.word_gather(table, idx, "cluster"), got)


def test_cluster_refuses_what_it_cannot_hold():
    idx = torch.zeros(4, dtype=torch.int32)
    over = torch.zeros(gathers.CLUSTER_WORDS + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="cluster"):
        gathers.word_gather(over, idx, "cluster")
    with pytest.raises(ValueError, match="cluster"):
        gathers.cluster_ranks(over.numel())
    for placement in ("cluster", "prefix"):
        with pytest.raises(ValueError, match=f"G3 has no {placement}"):
            gathers.chain_gather(torch.zeros(64, dtype=torch.int32), idx, 1,
                                 placement)
    assert gathers.word_gather(over, idx).tolist() == [0] * 4   # ldg


def test_wrappers_refuse_bad_input():
    t = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="placement"):
        gathers.word_gather(t, t, "vmem")
    with pytest.raises(ValueError, match="int32"):
        gathers.word_gather(t.long(), t)
    with pytest.raises(ValueError, match="chain"):
        gathers.chain_gather(t, t, 0)
    with pytest.raises(ValueError, match="index columns"):
        gathers.tile_gather(torch.zeros(8, 128, dtype=torch.int32),
                            torch.zeros(8, 64, dtype=torch.int32), 0)
    pos = torch.zeros(8, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="w_raw"):
        gathers.align(pos, torch.zeros(8 * 56, 128, dtype=torch.int32), 26)
    assert gathers.align(pos, torch.zeros(8 * 57, 128, dtype=torch.int32),
                         26).shape == (8 * 26, 128)
    with pytest.raises(ValueError, match="no word_gather_kernel"):
        gathers._launch("word_gather_kernel", "pfac_word_gather",
                        torch.device("meta"))


@pytest.mark.parametrize("hashed", [False, True])
def test_chain_plain_matches_numpy(hashed):
    rng = np.random.default_rng(5)
    w = 1000
    table = rng.integers(0, w, size=w).astype(np.int32) if not hashed else \
        rng.integers(-(1 << 31), 1 << 31, size=w, dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, w, size=5000).astype(np.int32)
    got = gathers.chain_gather(torch.from_numpy(table), torch.from_numpy(idx),
                               4, "smem", hashed).numpy()
    if hashed:
        want = gather_micro.chain_expect(table, idx, 4)
    else:
        want = table[table[table[table[idx]]]]
    assert np.array_equal(got, want)
    assert got.min() >= 0 and got.max() < w


def test_arena_sweep_small(monkeypatch):
    # the port's own arenas (a small ruleset on both tiers, the CSR tier
    # forced): G1 in every placement that fits, G3 chain 4 hashed
    rng = np.random.default_rng(9)
    pats = [bytes(rng.integers(0, 256, size=int(k), dtype=np.uint8))
            for k in rng.integers(1, 40, size=300)]
    eng = pt.Matcher(pats, device="cpu")._engine()
    monkeypatch.setattr(sieve_matcher, "build_walk_tables_gated",
                        lambda *a: None)
    engb = pt.Matcher(pats, device="cpu")._engine()
    assert eng.walk_tables is not None and engb.csr_tables is not None
    items = list(gather_micro.arena_cases(gather_micro.arenas_of(eng, engb),
                                          n_idx=3000))
    cases = [i for i in items if isinstance(i, harness.Case)]
    assert len(cases) >= 4 * 3
    for c in cases:
        assert harness.check(c) == 0
    for r in items:
        if isinstance(r, harness.Refusal):
            assert "shared memory" in harness.refuse(r)


def test_k1_loads():
    rows = [(1, 4, 8, 256, 300, 556, 1, 0),     # CHD exact: disp, key, val
            (1, 0, 8, -1, 812, 1068, 1, 0),     # no displacement: key, val
            (1, 4, 8, 1324, -1, 1340, 1, 0),    # CHD filter: disp, residual
            (0, 0, 0, -1, -1, -1, 0, 0)]        # absent
    assert gather_micro.k1_loads(rows) == 1 + 3 + 2 + 2


@pytest.mark.parametrize("mod", [lanegather_micro, gather_micro,
                                 dyngather_micro, align_micro,
                                 axis0_gather_probe, lanegather2_micro],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_main_needs_a_gpu(mod, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert mod.main() == 1
    assert "no GPU" in capsys.readouterr().err


def test_every_case_runs_small_on_cpu():
    items = itertools.chain(
        lanegather_micro.cases("cpu", n_idx=2048),
        gather_micro.cases("cpu", big=4096),
        dyngather_micro.cases("cpu", n_idx=2048),
        align_micro.cases("cpu", survivors=2048),
        axis0_gather_probe.cases("cpu"),
        lanegather2_micro.cases("cpu", n_idx=2048))
    names = []
    for item in items:
        if isinstance(item, harness.Refusal):
            harness.refuse(item)
        else:
            assert harness.check(item) == 0
        names.append(item.name)
    assert len(names) == len(set(names)) == 90
    assert not any(trace.launches(*gathers.KERNELS).values())  # no kernel

"""The port's programs (``pfac_tpu_torch.backends.program``: one CUDA graph a
call) and match count (``backends/count.py``) on the CPU.

A program runs only on the card; what the CPU can hold is what it is built
from. Its launch geometry, as :func:`program.geometry` computes it for a
132-SM card, equals what each per-kernel wrapper computes for its own
launch (the sieve's placement, the compaction's threshold and buffer, K2's
and K3's plans, the CSR walk's steps), for the Snort-like set (K2's tables
whole in shared memory), ROADMAP.md's F1 set (nothing of the walk tables
resident for K3, their entry table for K2), one of the F1
regime's sets
(``rulesets.f1_regime``, whose two rulesets of ``chip_smoke.py`` also
match the reference's golden model here) and a 100,000-signature set whose
sieve tables take the 2-CTA cluster; the scratch it carves holds each wrapper's buffer
at its size without overlap, and its ``Spec`` is the C struct's layout.
The count's plain version equals the reference's ``match_count`` on its
8-device CPU mesh (the walker engine, as ``test_torch_sharding.py`` runs
its non-sieve cases), and the sieve and sharded matchers on the CPU still
run ``pipeline.run``, never a program. Integers compare exactly.
"""
import ctypes
import os
import re

import numpy as np
import pytest
import torch

import pfac_tpu
from pfac_tpu.backends import golden as ref_golden
from pfac_tpu.dist import sharding as ref_sharding
import pfac_tpu_torch as pt
from pfac_tpu_torch import trace
from pfac_tpu_torch.backends import (block_walk, compact, count, golden,
                                     pipeline, program, reduce, sieve, walk)
from pfac_tpu_torch.backends.sieve_matcher import npad_for
from pfac_tpu_torch.dist.sharding import ShardedMatcher, make_data_mesh
from pfac_tpu_torch.experiments import rulesets

BLOCK = sieve.BLOCK


def _signatures_100k():
    """100,000 random 8-byte signatures (the big ruleset's shortest length):
    sieve tables that take the cluster placement, on the CSR tier, built
    in seconds."""
    rng = np.random.default_rng(100_000)
    return list(dict.fromkeys(rng.integers(0, 256, size=8, dtype=np.uint8)
                              .tobytes() for _ in range(100_000)))


def _f1():
    rng = np.random.default_rng(17000)
    return [bytes(rng.integers(0, 256, size=6, dtype=np.uint8))
            for _ in range(17000)]


RULESETS = {
    "snort": rulesets.snort_like_patterns,
    "f1": _f1,
    "f1_regime_20k": lambda: rulesets.f1_regime(20_000, 20_000, 1 << 10)[0],
    "100k": _signatures_100k,
}


@pytest.fixture(scope="module")
def engines():
    return {}


def _engine(engines, name):
    if name not in engines:
        engines[name] = pt.Matcher(RULESETS[name](), device="cpu")._engine()
    return engines[name]


@pytest.fixture
def card(monkeypatch):
    """A CUDA device of 132 SMs, as K3's plan reads it."""

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", list(RULESETS))
@pytest.mark.parametrize("mb,shards,red,cnt", [
    (128, 1, False, False), (128, 1, True, False), (1, 1, False, False),
    (32, 4, False, True)])
def test_geometry_equals_the_wrappers(engines, card, name, mb, shards, red,
                                      cnt):
    eng = _engine(engines, name)
    npad = npad_for(mb << 20)
    nblocks = npad // BLOCK
    geo = program.geometry(eng._sieve, eng._walk, eng._csr, npad, BLOCK,
                           card, shards=shards, reduce=red, count=cnt)
    want_tier = ("walk" if eng._walk is not None
                 else "csr" if eng._csr is not None else "sieve")
    assert (geo.tier, geo.nblocks, geo.shards) == (want_tier, nblocks, shards)
    # K1, as sieve.sieve launches it
    assert geo.placement == sieve.placement_for(eng._sieve)
    assert sieve.smem_bytes(geo.placement, eng._sieve) <= sieve.SMEM_LIMIT
    assert geo.sieve_words == eng._sieve.arena.numel()
    assert geo.res_off == sieve.residual_offset(eng._sieve)
    # the compaction, as pipeline.run and compact.compact size it
    thresh = pipeline.threshold(eng._walk, BLOCK)
    assert geo.thresh == thresh
    assert geo.capacity == compact.capacity(nblocks, BLOCK, thresh)
    if eng._walk is not None:      # K2 and K3, as walk.walk and block_walk
        assert (geo.walk_nsteps, geo.k2_resident) == walk.launch_plan(
            eng._walk, card)
        assert (geo.k2_resident == geo.walk_words) == (name == "snort")
        assert (geo.walk_nsteps, geo.look, geo.tile_cap,
                geo.k3_resident) == block_walk.launch_plan(
            eng._walk, npad // block_walk.CHUNK, card)
        assert geo.walk_words == eng._walk.arena.numel()
    else:
        assert geo.csr_nsteps == len(eng._csr.rows) - 1
    # the scratch: each wrapper's buffer at its size, aligned, no overlap
    parts = [(geo.bits_at, 4 * (npad // 32)),
             (geo.counts_at, 4 * (nblocks + 1))]
    if geo.tier != "sieve":
        parts += [(geo.offsets_at, 4 * (nblocks + 1)),
                  (geo.pos_at, 4 * geo.capacity)]
    if red:
        parts.append((geo.match_at, 4 * npad))
    else:
        assert geo.match_at == -1
    parts.sort()
    assert all(at % program.ALIGN == 0 for at, _ in parts)
    assert all(a + s <= b for (a, s), (b, _) in zip(parts, parts[1:]))
    assert parts[-1][0] + parts[-1][1] <= geo.shard_bytes
    assert geo.shard_bytes % program.ALIGN == 0
    assert geo.scratch_bytes == shards * geo.shard_bytes
    # the result: the match a shard (or ids, positions, count), the count
    assert geo.result_words == (2 * npad + 4 if red
                                else shards * npad + 2 * cnt)
    assert geo.count_at == (4 * shards * npad if cnt else -1)


def test_f1_sets_put_nothing_in_shared_memory(engines, card):
    # nothing of the walk tables fits K3's shared memory; K2, with more
    # room, keeps their entry table there and reads the rest through
    # L1/L2
    for name in ("f1", "f1_regime_20k"):
        eng = _engine(engines, name)
        geo = program.geometry(eng._sieve, eng._walk, eng._csr,
                               npad_for(4 << 20), BLOCK, card)
        entry = walk.table_ends(eng._walk)[0]
        assert geo.tier == "walk" and geo.k3_resident == 0
        assert geo.k2_resident == entry < geo.walk_words


@pytest.mark.parametrize("seed,k", [(20_000, 20_000), (30_000, 30_000)])
def test_f1_regime_vs_reference_golden(seed, k):
    # chip_smoke.py's two rulesets of the F1 regime on 64 KB of their
    # planted corpus: the port's CPU match against the reference's golden
    pats, host = rulesets.f1_regime(seed, k, 1 << 16)
    assert len(pats) == k and {len(p) for p in pats} == set(range(3, 9))
    m = pt.Matcher(pats, device="cpu")
    got = m.match(host.tobytes())
    assert got.tolist() == ref_golden.match_edges_batch(
        pfac_tpu.Automaton.from_patterns(pats), host.tobytes()).tolist()
    assert (got > 0).sum() > (1 << 16) // 97


def test_100k_set_takes_the_cluster(engines, card):
    eng = _engine(engines, "100k")
    geo = program.geometry(eng._sieve, eng._walk, eng._csr,
                           npad_for(128 << 20), BLOCK, card)
    assert (geo.placement, geo.tier) == ("cluster", "csr")
    assert geo.thresh == BLOCK + 1 and geo.capacity == npad_for(128 << 20)


@pytest.mark.parametrize("name,tier_kernels", [
    ("snort", {"sieve_smem_kernel", "compact_scan_kernel", "compact_kernel",
               "walk_kernel", "block_walk_kernel"}),
    ("100k", {"sieve_cluster_kernel", "compact_scan_kernel", "compact_kernel",
              "csr_walk_kernel"})])
def test_spec_and_counted_kernels(engines, card, name, tier_kernels):
    # the Spec carries the geometry field for field in the C struct's
    # layout; a call counts each kernel of its tier once a shard, the
    # reduce's once and the count once
    eng = _engine(engines, name)
    geo = program.geometry(eng._sieve, eng._walk, eng._csr, npad_for(8 << 20),
                           BLOCK, card, shards=3, count=True)
    prog = program.Program(geo, eng._sieve, eng._walk, eng._csr, card)
    # 25 int32 fields (and 4 bytes of padding), 7 int64 fields, 8 pointers
    assert ctypes.sizeof(program.Spec) == 25 * 4 + 4 + 7 * 8 + 8 * 8
    for field, _ in program.Spec._fields_:
        value = getattr(prog.spec, field)
        if field == "counters":         # the device's words, at the build
            assert value is None
        elif field == "placement":
            assert value == sieve.PLACEMENTS.index(geo.placement)
        elif field == "tier":
            assert value == program.TIERS.index(geo.tier)
        elif field.endswith("_word"):   # the kernels' counter words
            assert value == program.counter_words()[field], field
        elif field.endswith(("_arena", "_desc", "_records")):
            tabs = {"sieve": eng._sieve, "walk": eng._walk,
                    "csr": eng._csr}[field.split("_")[0]]
            want = None if tabs is None else getattr(
                tabs, field.split("_")[1]).data_ptr()
            assert value == want, field
        elif field != "device":
            assert value == int(getattr(geo, field)), field
    assert prog.kernels == {**dict.fromkeys(tier_kernels, 3),
                            "count_kernel": 1}
    red = program.Program(
        program.geometry(eng._sieve, eng._walk, eng._csr, npad_for(1 << 20),
                         BLOCK, card, reduce=True),
        eng._sieve, eng._walk, eng._csr, card)
    assert red.kernels == {**dict.fromkeys(tier_kernels, 1),
                           "reduce_kernel": 1, "reduce_tail_kernel": 1}
    assert not red.handle               # built at the first call, on a card


def _c_spec_fields() -> list[str]:
    """The field names of ``struct Spec`` in csrc/program.cu, in order."""
    path = os.path.join(os.path.dirname(program.__file__), os.pardir, "csrc",
                        "program.cu")
    with open(path) as f:
        body = re.search(r"struct Spec \{(.*?)\n\};", f.read(), re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in body.split(";"):
        words = decl.replace("*", " ").replace(",", " , ").split()
        if words:       # the type, then names (`const void*` is one type)
            names = " ".join(words).split(" , ")
            out.append(names[0].split()[-1])
            out += [nm.strip() for nm in names[1:]]
    return out


def test_counter_words_follow_the_device_keys(monkeypatch):
    # each kernel's counter words are where trace.DEVICE_KEYS puts its
    # keys, handed to C in the Spec, whose fields are the C struct's in
    # order; a key order that parts a kernel's two words is refused
    words = program.counter_words()
    assert set(words) == set(program.COUNTERS)
    for field, keys in program.COUNTERS.items():
        at = words[field]
        assert trace.DEVICE_KEYS[at:at + len(keys)] == keys
    assert words["block_walk_word"] == 5 and words["compact_word"] == 7
    assert len(trace.DEVICE_KEYS) == 8
    assert _c_spec_fields() == [f for f, _ in program.Spec._fields_]
    monkeypatch.setattr(trace, "DEVICE_KEYS", (
        "survivors", "blocks_escaped", "short_probes", "walk_steps",
        "block_walk_probes", "walk_slots", "block_walk_positions"))
    with pytest.raises(ValueError, match="in a row"):
        program.counter_words()


@pytest.mark.parametrize("name,key", [("snort", "walk.whole_calls"),
                                      ("f1", "walk.split_calls"),
                                      ("100k", None)])
def test_program_counts_k2_whole_and_split_calls(engines, card, name, key):
    # a walk-tier program counts each call as whole (K2's tables resident
    # whole) or split, by its plan, once a call whatever its shards or
    # reduce; the CSR tier counts neither
    eng = _engine(engines, name)
    trace.reset()
    calls = 0
    for shards, red in ((1, False), (2, False), (1, True)):
        geo = program.geometry(eng._sieve, eng._walk, eng._csr,
                               npad_for(1 << 20), BLOCK, card, shards=shards,
                               reduce=red)
        prog = program.Program(geo, eng._sieve, eng._walk, eng._csr, card)
        for _ in range(shards + 2):
            prog._counted(0)
            calls += 1
    got = trace.counters()
    want = {"walk.whole_calls": 0, "walk.split_calls": 0,
            "launch.program": calls}
    if key is not None:
        want[key] = calls
    assert {k: got[k] for k in want} == want


def test_geometry_refuses_what_no_program_runs(engines, card):
    eng = _engine(engines, "snort")
    for kw in ({"npad": 0}, {"npad": BLOCK + 1}, {"npad": BLOCK, "shards": 0},
               {"npad": BLOCK, "shards": 2, "reduce": True}):
        with pytest.raises(ValueError):
            program.geometry(eng._sieve, eng._walk, eng._csr, block=BLOCK,
                             device=card, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_count_plain_equals_reference_match_count(seed):
    # the walker engine on 8 CPU shards: the count the port sums from
    # count_nonzero_plain equals the reference's match_count on its mesh
    rng = np.random.default_rng(seed)
    pats = list(dict.fromkeys(rng.integers(97, 101, size=int(k),
                                           dtype=np.uint8).tobytes()
                              for k in rng.integers(1, 6, size=12)))
    data = rng.integers(97, 101, size=999, dtype=np.uint8).tobytes()
    sm = ShardedMatcher(pt.Automaton.from_patterns(pats),
                        mesh=make_data_mesh(devices=["cpu"] * 8), tile=16)
    assert sm.engine == "xla"
    ref = ref_sharding.ShardedMatcher(pfac_tpu.Automaton.from_patterns(pats),
                                      mesh=ref_sharding.make_data_mesh(8),
                                      tile=16)
    want = ref.match_count(data)
    n = len(data)
    results, got = sm.match_device(
        sm._put(np.frombuffer(data, np.uint8), sm._shard_len(n)), n)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want == sm.match_count(data)
    assert int(got) == sum(int(count.count_nonzero_plain(r))
                           for r in results)
    assert int(count.count_nonzero(torch.cat(results))) == want
    assert want == int((golden.match_dense(sm.automaton, data) > 0).sum())


def test_count_refuses_what_it_cannot_count():
    with pytest.raises(ValueError):
        count.count_nonzero(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        count.count_nonzero(torch.zeros(8, dtype=torch.int32)[::2])
    assert int(count.count_nonzero(torch.zeros(0, dtype=torch.int32))) == 0
    assert count.bound_bytes(1 << 27) == 1 << 29


def test_cpu_matchers_never_build_a_program(engines, monkeypatch):
    # the CPU path stays pipeline.run: results unchanged, no program built
    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor reached a program")

    monkeypatch.setattr(program, "match", refuse)
    monkeypatch.setattr(program, "match_shards", refuse)
    pats = [b"AB", b"ABG", b"BEDE", b"ED", b"zzzz"]
    m = pt.Matcher(pats, device="cpu")
    eng = m._engine()
    rng = np.random.default_rng(5)
    host = rng.choice(np.frombuffer(b"ABEDGz", np.uint8), size=70_000)
    d = torch.from_numpy(host)
    want = golden.match_dense(m.automaton, host)
    got = eng.match_device(d)
    assert np.array_equal(got[:host.shape[0]].numpy(), want)
    assert torch.equal(got, pipeline.run(d, host.shape[0], got.shape[0],
                                         eng._sieve, eng._walk, eng._csr))
    ids, pos, c = eng.match_reduce_device(d)
    w_ids, w_pos, w_c = reduce.reduce_plain(got)
    assert torch.equal(ids, w_ids) and torch.equal(pos, w_pos)
    assert int(c) == int(w_c) == int((want > 0).sum())
    sm = ShardedMatcher(m.automaton, mesh=make_data_mesh(devices=["cpu"] * 3),
                        engine="sieve", tile_rows=64)
    assert np.array_equal(sm.match(host), want)
    assert sm.match_count(host) == int((want > 0).sum())
    assert eng._programs == {}

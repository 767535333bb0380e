"""The port's sharded matcher (``pfac_tpu_torch.dist.sharding``) on eight
CPU shards, the counterpart of ``tests/test_sharding.py``.

Each case runs the same seeded input through the port's ``ShardedMatcher``
on ``devices=["cpu"] * 8`` (the sieve engine's kernels as their plain torch
versions, ``tile_rows=64``), through the reference's ``ShardedMatcher`` on
its virtual 8-device CPU mesh and through the golden model, and holds them
equal, bit-exact (tolerance 0). The reference runs as its own tests run
it: the sieve engine in interpret mode for the sieve cases, the walker
engine for the others.
"""
import jax
import numpy as np
import pytest
import torch

import pfac_tpu
from pfac_tpu.dist import sharding as ref_sharding
from pfac_tpu_torch import Automaton, PfacError
from pfac_tpu_torch.backends import golden
from pfac_tpu_torch.dist import multihost
from pfac_tpu_torch.dist.sharding import (DataMesh, ShardedMatcher,
                                          device_mesh, make_data_mesh)

CPU8 = ["cpu"] * 8
SIEVE = {"engine": "sieve", "interpret": True}   # the reference's sieve


@pytest.fixture(scope="module")
def mesh8():
    return make_data_mesh(devices=CPU8)


@pytest.fixture(scope="module")
def ref_mesh8():
    assert len(jax.devices()) == 8, "conftest must force 8 virtual CPU devices"
    return ref_sharding.make_data_mesh(8)


def _ref(pats, ref_mesh, hashed=False, **kw):
    a = pfac_tpu.Automaton.from_patterns(pats, hashed=hashed)
    return ref_sharding.ShardedMatcher(a, mesh=ref_mesh, **kw)


def _all_equal(pats, data, sm, ref, hashed=False):
    """The port's match, the reference's and golden's agree; -> golden."""
    want = golden.match_dense(
        Automaton.from_patterns(pats, hashed=hashed), data)
    got = sm.match(data)
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(ref.match(data), want)
    return want


class TestShardedMatcher:
    def test_readme_example(self, mesh8, ref_mesh8, example_pattern_path,
                            example_input):
        a = Automaton.from_pattern_file(example_pattern_path)
        sm = ShardedMatcher(a, mesh=mesh8, tile=4)
        assert sm.engine == "xla"
        ref = ref_sharding.ShardedMatcher(
            pfac_tpu.Automaton.from_pattern_file(example_pattern_path),
            mesh=ref_mesh8, tile=4)
        assert sm.match(example_input).tolist() == \
            ref.match(example_input).tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0, 0]

    def test_boundary_spanning_matches(self, mesh8, ref_mesh8):
        tile = 8
        n = 8 * tile
        data = bytearray(b"a" * n)
        for b in range(tile - 2, n - 4, tile):   # straddle each boundary
            data[b:b + 4] = b"xyzw"
        sm = ShardedMatcher(Automaton.from_patterns([b"xyzw"]), mesh=mesh8,
                            tile=tile)
        _all_equal([b"xyzw"], bytes(data), sm,
                   _ref([b"xyzw"], ref_mesh8, tile=tile))

    @pytest.mark.parametrize("perf_mode", ["dense", "hash"])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_random_vs_golden(self, mesh8, ref_mesh8, perf_mode, seed):
        rng = np.random.default_rng(seed)
        alpha = rng.integers(0, 256, size=4).astype(np.uint8)
        pats = [bytes(alpha[rng.integers(0, 4, size=int(rng.integers(1, 7)))])
                for _ in range(int(rng.integers(1, 8)))]
        data = bytes(alpha[rng.integers(0, 4, size=333)])
        hashed = perf_mode == "hash"
        sm = ShardedMatcher(Automaton.from_patterns(pats, hashed=hashed),
                            mesh=mesh8, perf_mode=perf_mode, tile=16)
        _all_equal(pats, data, sm,
                   _ref(pats, ref_mesh8, hashed, perf_mode=perf_mode,
                        tile=16), hashed)

    def test_match_count(self, mesh8, ref_mesh8):
        data = b"ab" * 64
        sm = ShardedMatcher(Automaton.from_patterns([b"ab"]), mesh=mesh8,
                            tile=8)
        assert sm.match_count(data) == \
            _ref([b"ab"], ref_mesh8, tile=8).match_count(data) == 64
        shards = sm._put(np.frombuffer(data, np.uint8), sm._shard_len(128))
        results, count = sm.match_device(shards, 128)
        # a 0-d int64 tensor: a count over >= 2 GiB needs 64 bits
        assert count.dim() == 0 and count.dtype == torch.int64
        assert len(results) == 8 and int(count) == 64
        assert results[0].dtype == torch.int32

    def test_match_reduce(self, mesh8, ref_mesh8):
        pats = [b"AB", b"ABG", b"BEDE", b"ED"]
        sm = ShardedMatcher(Automaton.from_patterns(pats), mesh=mesh8, tile=4)
        ids, pos, n = sm.match_reduce(b"ABEDEDABG")
        r_ids, r_pos, r_n = _ref(pats, ref_mesh8, tile=4).match_reduce(
            b"ABEDEDABG")
        assert (n, pos.tolist(), ids.tolist()) == (
            r_n, r_pos.tolist(), r_ids.tolist()) == (
            5, [0, 1, 2, 4, 6], [1, 3, 4, 4, 2])
        assert pos.dtype == np.int64 and ids.dtype == np.int32

    @pytest.mark.parametrize("engine", ["xla", "sieve"])
    def test_input_smaller_than_mesh(self, mesh8, ref_mesh8, engine):
        # seven of the eight shards hold no byte (n_valid = 0): they
        # launch nothing and report zeros
        sm = ShardedMatcher(Automaton.from_patterns([b"ab"]), mesh=mesh8,
                            tile=4, engine=engine)
        ref = _ref([b"ab"], ref_mesh8, tile=4)
        assert sm.match(b"ab").tolist() == ref.match(b"ab").tolist() == [1, 0]
        assert sm.match_count(b"ab") == 1
        ids, pos, c = sm.match_reduce(b"ab")
        assert (c, pos.tolist(), ids.tolist()) == (1, [0], [1])

    def test_subset_mesh(self):
        data = b"xxabxx" * 10
        sm = ShardedMatcher(Automaton.from_patterns([b"ab"]),
                            mesh=make_data_mesh(2, devices=CPU8), tile=8)
        assert sm.num_devices == 2
        ref = _ref([b"ab"], ref_sharding.make_data_mesh(2), tile=8)
        _all_equal([b"ab"], data, sm, ref)


class TestShardedSieve:
    """The sieve engine on each shard (the plain versions on the CPU)."""

    def test_boundary_matches_vs_golden(self, mesh8, ref_mesh8):
        rng = np.random.default_rng(3)
        pats = [b"q", b"qw", b"qwe", b"qwert", b"hello", b"lo wor"]
        sm = ShardedMatcher(Automaton.from_patterns(pats), mesh=mesh8,
                            engine="sieve")
        assert sm.tile_rows == 64
        n = 2 * 65536 * 8 + 12345
        data = bytearray(rng.integers(97, 123, size=n,
                                      dtype=np.uint8).tobytes())
        sl = sm._shard_len(n)
        for b in range(sl, n - 8, sl):           # straddle every boundary
            data[b - 3:b + 3] = b"qwerth"[:6]
        data[:5] = b"hello"
        data[-5:] = b"hello"
        data = bytes(data)
        want = _all_equal(pats, data, sm, _ref(pats, ref_mesh8, **SIEVE))
        assert sm.match_count(data) == int((want > 0).sum())

    def test_moderate_survivor_density(self, mesh8, ref_mesh8):
        pats = [b"aaaaaaa", b"bq"]
        sm = ShardedMatcher(Automaton.from_patterns(pats), mesh=mesh8,
                            engine="sieve")
        rng = np.random.default_rng(0)
        data = bytearray(rng.integers(98, 122, size=65536 * 8,
                                      dtype=np.uint8).tobytes())
        for off in range(0, len(data) - 8, 500):  # ~130 survivors a shard
            data[off:off + 7] = b"aaaaaaa"
        _all_equal(pats, bytes(data), sm, _ref(pats, ref_mesh8, **SIEVE))

    def test_csr_tier_sharded(self, mesh8, ref_mesh8, monkeypatch):
        # the CSR walk in every shard, boundary matches through the halo
        import pfac_tpu.backends.pallas_sieve as S
        from pfac_tpu_torch.backends import sieve_matcher
        monkeypatch.setattr(S, "build_walk_tables_gated", lambda *a: None)
        monkeypatch.setattr(sieve_matcher, "build_walk_tables_gated",
                            lambda *a: None)
        pats = [b"abcdefgh", b"bcq", b"defghijk"]
        sm = ShardedMatcher(Automaton.from_patterns(pats), mesh=mesh8,
                            engine="sieve")
        assert sm._engines[torch.device("cpu")].csr_tables is not None
        rng = np.random.default_rng(7)
        data = bytearray(rng.integers(97, 123, size=4096 * 8,
                                      dtype=np.uint8).tobytes())
        shard = sm._shard_len(len(data))
        for off in range(0, len(data) - 16, 333):
            data[off:off + 8] = b"abcdefgh"
        for b in range(shard, len(data), shard):   # every boundary
            data[b - 3:b + 5] = b"abcdefgh"
        # the reference's sieve engine (interpret mode), CSR tier too
        ref = _ref(pats, ref_mesh8, **SIEVE)
        assert ref._csr_tables is not None
        _all_equal(pats, bytes(data), sm, ref)

    def test_pathological_corpus_handled(self, mesh8, ref_mesh8):
        pats = [b"aaaaaaa"]
        sm = ShardedMatcher(Automaton.from_patterns(pats), mesh=mesh8,
                            engine="sieve")
        _all_equal(pats, b"a" * (65536 * 8), sm,
                   _ref(pats, ref_mesh8, **SIEVE))


class TestMultihostGlue:
    def test_host_shard_slice_covers_everything(self, mesh8):
        shard_len = 128
        n_total = 8 * shard_len
        assert multihost.host_shard_slice(n_total, shard_len, mesh8) == (
            0, n_total)

    def test_put_host_shards_roundtrip(self, mesh8):
        sm = ShardedMatcher(Automaton.from_patterns([b"ab"]), mesh=mesh8,
                            tile=8)
        total = 8 * 16
        local = np.arange(total, dtype=np.uint8)
        shards = multihost.put_host_shards(sm, local, total)
        assert len(shards) == 8
        assert all(s.shape[0] == 16 + sm.halo and s.data_ptr() % 16 == 0
                   for s in shards)
        assert np.array_equal(
            np.concatenate([s[:16].numpy() for s in shards]), local)


class TestShardedDeviceReduce:
    def test_sieve_reduce_matches_golden(self, mesh8, ref_mesh8):
        rng = np.random.default_rng(21)
        pats = [b"wxyz!", b"wx", b"q", b"wxyzab"]
        sm = ShardedMatcher(Automaton.from_patterns(pats), mesh=mesh8,
                            engine="sieve")
        n = 8 * 8192 - 1000
        data = bytearray(rng.integers(97, 123, size=n,
                                      dtype=np.uint8).tobytes())
        shard = sm._shard_len(n)
        for b in range(shard - 3, n - 8, shard):   # straddle boundaries
            data[b:b + 6] = b"wxyzab"
        data = bytes(data)
        ids, pos, count = sm.match_reduce(data)
        ref = _ref(pats, ref_mesh8, **SIEVE)
        r_ids, r_pos, r_count = ref.match_reduce(data)
        g_ids, g_pos, g_count = golden.reduce_result(
            golden.match_dense(sm.automaton, data))
        assert count == r_count == g_count
        assert pos.tolist() == r_pos.tolist() == g_pos.tolist()
        assert ids.tolist() == r_ids.tolist() == g_ids.tolist()
        assert pos.dtype == np.int64

    def test_small_reduce_cap(self, mesh8, ref_mesh8):
        # more matches a shard than the cap: the reference falls back to
        # its dense path; the port's reduce has no cap
        sm = ShardedMatcher(Automaton.from_patterns([b"ab"]), mesh=mesh8,
                            engine="sieve", reduce_cap=4)
        data = b"ab" * 400
        ids, pos, count = sm.match_reduce(data)
        ref = _ref([b"ab"], ref_mesh8, tile=8, reduce_cap=4)
        r_ids, r_pos, r_count = ref.match_reduce(data)
        assert (count, pos.tolist(), ids.tolist()) == (
            r_count, r_pos.tolist(), r_ids.tolist())
        assert count == 400


class TestShardedDenseEscape:
    def test_all_match_across_shards(self, mesh8, ref_mesh8):
        # every shard's blocks take the dense-block escape (K3's plain
        # version); the last real block's lookahead comes from the halo
        pats = [b"aaaa", b"a" * 40, b"abab"]
        sm = ShardedMatcher(Automaton.from_patterns(pats), mesh=mesh8,
                            engine="sieve")
        n = 8 * 8192 + 777
        d = np.full(n, ord("a"), np.uint8)
        d[3000:3010] = ord("b")
        want = _all_equal(pats, bytes(d), sm, _ref(pats, ref_mesh8, **SIEVE))
        assert sm.match_count(bytes(d)) == int((want > 0).sum())


@pytest.mark.parametrize("engine", ["xla", "sieve"])
def test_shards_past_the_end_are_zero(engine):
    # n_valid = 0 shards through match_device: zeros, no launch needed
    sm = ShardedMatcher(Automaton.from_patterns([b"abcd", b"cd"]),
                        mesh=make_data_mesh(devices=["cpu"] * 4),
                        engine=engine, tile=8192)
    data = np.frombuffer(b"xxabcdxx" * 100, np.uint8)
    sl = sm._shard_len(800)                  # 800 B: shard 0 only
    results, count = sm.match_device(sm._put(data, sl), data.shape[0])
    assert [int(r.any()) for r in results] == [1, 0, 0, 0]
    assert all(r.shape[0] == sl for r in results)
    got = torch.cat(results)[:800].numpy()
    assert np.array_equal(got, golden.match_dense(sm.automaton, data))
    assert int(count) == 200


@pytest.mark.parametrize("engine,cut", [("xla", 0), ("xla", 1),
                                        ("sieve", 0), ("sieve", 1),
                                        ("sieve", 2)])
def test_halo_of_exactly_max_len(engine, cut):
    """The longest pattern planted across every boundary, starting on the
    shard's last byte (odd boundaries) or ending on the next shard's first
    (even ones): equal to golden with the halo of max_len. With the halo
    cut by `cut` bytes it must still hold while the halo covers what a
    match needs (max_len - 1 bytes past the shard), and past that lose
    exactly the matches that start on a shard's last byte, which shows the
    plants straddle. (The walker indexes past a halo cut by 2.)"""
    long = bytes(range(100, 140))            # 40 bytes, the longest
    pats = [long, long[:4], b"zz"]
    sm = ShardedMatcher(Automaton.from_patterns(pats),
                        mesh=make_data_mesh(devices=["cpu"] * 8),
                        engine=engine, tile=8192)
    assert sm.halo == len(long)
    sm.halo -= cut
    rng = np.random.default_rng(40)
    n = 8 * 8192 - 100
    data = rng.integers(0, 90, size=n, dtype=np.uint8)
    sl = sm._shard_len(n)
    starts, ends = [], []
    for k, b in enumerate(range(sl, n - 50, sl)):
        s = b - 1 if k % 2 else b - len(long) + 1
        data[s:s + len(long)] = np.frombuffer(long, np.uint8)
        (starts if k % 2 else ends).append(s)
    want = golden.match_dense(sm.automaton, data)
    assert len(starts) == 3 and all(want[s] == 1 for s in starts + ends)
    got = sm.match(data)
    if cut <= 1:
        assert np.array_equal(got, want)
    else:                      # b - 1 needs max_len - 1 bytes past b
        bad = np.nonzero(got != want)[0]
        assert bad.tolist() == starts


def test_repeated_devices():
    # two shards on one device, as a one-card host runs them
    pats = [b"hello", b"llo w", b"ow"]
    sm = ShardedMatcher(Automaton.from_patterns(pats),
                        mesh=make_data_mesh(devices=["cpu", "cpu"]),
                        engine="sieve")
    assert len(sm._engines) == 1              # the tables placed once
    data = b"say hello world, " * 3000
    want = golden.match_dense(sm.automaton, data)
    assert np.array_equal(sm.match(data), want)
    assert sm.match_count(data) == int((want > 0).sum())


def test_engine_built_beforehand_serves_every_shard():
    # a SieveMatcher passed as the engine: its own device uses it, tables
    # and all; another device gets one built from its host tables
    from pfac_tpu_torch.backends.sieve_matcher import SieveMatcher
    a = Automaton.from_patterns([b"hello", b"llo w", b"ow"])
    eng = SieveMatcher(a, device="cpu", tile_rows=64)
    sm = ShardedMatcher(a, mesh=make_data_mesh(devices=["cpu"] * 3),
                        engine=eng)
    assert (sm.engine, sm.tile_rows) == ("sieve", 64)
    assert list(sm._engines.values()) == [eng]
    data = b"say hello world, " * 2000
    want = golden.match_dense(a, data)
    assert np.array_equal(sm.match(data), want)
    assert np.array_equal(sm.match(data), eng.match(data))
    with pytest.raises(ValueError):
        ShardedMatcher(a, mesh=make_data_mesh(devices=CPU8), engine="gpu")


def test_mesh_never_takes_the_cpu_by_itself():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(PfacError):
        make_data_mesh()
    with pytest.raises(PfacError):
        ShardedMatcher(Automaton.from_patterns([b"ab"]))
    assert device_mesh("cpu", 3).devices == (torch.device("cpu"),) * 3
    assert device_mesh("cpu").local_shards == 1


def test_auto_engine_and_limits():
    a = Automaton.from_patterns([b"ab"])
    sm = ShardedMatcher(a, mesh=make_data_mesh(devices=CPU8))
    assert sm.engine == "xla"                  # the CPU takes the walker
    with pytest.raises(PfacError):
        sm._check_len(1 << 31)                 # past int32 positions


class _TwoRanks:
    """A process group's rank and size, for meshes no process joins."""

    def rank(self):
        return 1

    def size(self):
        return 2


def test_multi_process_mesh_refuses_host_calls():
    mesh = DataMesh((torch.device("cpu"),) * 2, _TwoRanks())
    assert (mesh.size, mesh.global_index(0), mesh.global_index(1)) == (4, 2, 3)
    assert multihost.host_shard_slice(1000, 128, mesh) == (256, 512)
    sm = ShardedMatcher(Automaton.from_patterns([b"ab"]), mesh=mesh, tile=8)
    for call in (sm.match, sm.match_reduce):
        with pytest.raises(PfacError):
            call(b"abab")

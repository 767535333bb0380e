"""The port's multi-process glue (``pfac_tpu_torch.dist.multihost``) on the
CPU: the two-process gloo run of ``experiments/multihost_smoke.py`` under a
time limit of its own, and a one-rank gloo group in this process, whose
halo heads and count go through the collectives, equal to the mesh with no
group and to the reference's sharded matcher."""
import numpy as np
import pytest
import torch

import pfac_tpu
from pfac_tpu.dist import sharding as ref_sharding
from pfac_tpu_torch import Automaton
from pfac_tpu_torch.backends import golden
from pfac_tpu_torch.dist import multihost
from pfac_tpu_torch.dist.sharding import ShardedMatcher, make_data_mesh
from pfac_tpu_torch.experiments import multihost_smoke


def test_two_processes_over_gloo(capsys):
    # the smoke run kills both processes and fails past its time limit
    assert multihost_smoke.main(["--cpu", "--timeout", "180"]) == 0
    out = capsys.readouterr().out
    assert "MULTIHOST SMOKE: PASS" in out
    for p in range(2):
        for engine in ("xla", "sieve"):
            assert f"[process {p}] {engine} ok" in out


def test_smoke_run_needs_a_gpu_unless_asked_for_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert multihost_smoke.main([]) == 1
    assert "--cpu" in capsys.readouterr().err


def test_initialize_is_a_noop_for_one_process():
    import torch.distributed as dist

    multihost.initialize("localhost:1", 1, 0)
    multihost.initialize()
    assert not dist.is_initialized()


def test_backend_follows_the_devices():
    assert multihost.backend_for(["cpu", "cpu"]) == "gloo"
    assert multihost.backend_for(["cuda:0"]) == "nccl"
    assert multihost.backend_for(None) == "nccl"


def test_global_mesh_without_a_group():
    mesh = multihost.global_mesh(["cpu"] * 3)
    assert mesh.group is None and mesh.size == 3
    assert multihost.host_shard_slice(1000, 512, mesh) == (0, 1000)


@pytest.mark.parametrize("engine", ["xla", "sieve"])
def test_one_rank_group_equals_no_group(tmp_path, engine):
    import torch.distributed as dist

    pats = [b"abcd", b"cdefgh", b"zz"]
    rng = np.random.default_rng(5)
    n = 3 * 8192 + 11
    data = rng.integers(97, 123, size=n, dtype=np.uint8)
    a = Automaton.from_patterns(pats)
    plain = ShardedMatcher(a, mesh=make_data_mesh(devices=["cpu"] * 4),
                           engine=engine, tile=4096)
    sl = plain._shard_len(n)
    for b in range(sl, n - 8, sl):
        data[b - 3:b + 3] = np.frombuffer(b"cdefgh", np.uint8)
    want = golden.match_dense(a, data)
    multihost.initialize(f"file://{tmp_path / 'store'}", 1, 0, ["cpu"])
    try:
        mesh = multihost.global_mesh(["cpu"] * 4)
        assert (mesh.world, mesh.rank, mesh.size) == (1, 0, 4)
        sm = ShardedMatcher(a, mesh=mesh, engine=engine, tile=4096)
        assert multihost.host_shard_slice(n, sl, mesh) == (0, n)
        shards = multihost.put_host_shards(sm, data, 4 * sl)
        results, count = sm.match_device(shards, n)
    finally:
        dist.destroy_process_group()
    got = torch.cat(results).numpy()
    assert np.array_equal(got[:n], want) and not got[n:].any()
    assert int(count) == int((want > 0).sum())
    assert np.array_equal(plain.match(data), want)
    ref = ref_sharding.ShardedMatcher(pfac_tpu.Automaton.from_patterns(pats),
                                      mesh=ref_sharding.make_data_mesh(4),
                                      tile=4096)
    assert np.array_equal(ref.match(data.tobytes()), want)

"""Multi-process glue: counterpart of ``pfac_tpu.dist.multihost``.

``initialize`` brings up a ``torch.distributed`` process group (NCCL where
the process's shards are on GPUs, gloo on the CPU), ``global_mesh`` joins
every process's local devices into one mesh, and the sharded matcher of
``sharding.py`` runs over it unchanged: the halo heads travel in one
``all_gather`` and the match count in one ``all_reduce``.

Per-process feeding: each process loads only its own byte range
(:func:`host_shard_slice`) and places it in its shard buffers
(:func:`put_host_shards`); ``ShardedMatcher.match_device`` then returns its
own shards' results and the global count, as the reference's
``experiments/multihost_smoke.py`` reads them.
"""
from __future__ import annotations

import datetime

import numpy as np
import torch

from .sharding import DataMesh, ShardedMatcher, make_data_mesh

_TIMEOUT = datetime.timedelta(seconds=120)


def backend_for(devices) -> str:
    """NCCL where the shards are on GPUs, gloo on the CPU."""
    cuda = devices is None or any(torch.device(d).type == "cuda"
                                  for d in devices)
    return "nccl" if cuda else "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, devices=None) -> None:
    """Bring up the process group of `num_processes` processes.
    `coordinator_address` is ``host:port`` (a TCP store on that host) or a
    URL (``tcp://...``, ``file:///path``); `devices` are this process's
    shard devices (default: the GPUs), which pick the backend. For a
    single process it is a no-op, unless `coordinator_address` is a URL:
    then a group of one rank, whose collectives run as a multi-process
    mesh runs them."""
    if num_processes is None or num_processes <= 1:
        if coordinator_address is None or "://" not in coordinator_address:
            return
        num_processes, process_id = 1, 0
    import torch.distributed as dist

    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend_for(devices), init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=_TIMEOUT)


def global_mesh(devices=None) -> DataMesh:
    """A mesh over every process's shards: this process contributes
    `devices` (default: every visible GPU), every process as many."""
    import torch.distributed as dist

    local = make_data_mesh(devices=devices).devices
    if not dist.is_initialized():
        return DataMesh(local)
    mesh = DataMesh(local, dist.group.WORLD)
    ex = mesh.exchange_device()
    mine = torch.tensor([len(local)], device=ex)
    every = [torch.empty_like(mine) for _ in range(mesh.world)]
    dist.all_gather(every, mine)
    if any(int(c) != len(local) for c in every):
        raise ValueError(f"shards per process differ: "
                         f"{[int(c) for c in every]}")
    return mesh


def host_shard_slice(n_total: int, shard_len: int,
                     mesh: DataMesh | None = None) -> tuple[int, int]:
    """[start, stop) of the global input this process must load: the union
    of its shards' ranges, shard g owning [g * shard_len, (g + 1) *
    shard_len). `mesh` defaults to :func:`global_mesh`."""
    mesh = mesh or global_mesh()
    start = mesh.global_index(0) * shard_len
    stop = start + mesh.local_shards * shard_len
    return min(start, n_total), min(stop, n_total)


def put_host_shards(matcher: ShardedMatcher, local_bytes: np.ndarray,
                    global_len_padded: int) -> list[torch.Tensor]:
    """This process's shard buffers from its own slice of the input (the
    range :func:`host_shard_slice` gives), for ``match_device``."""
    shard_len = global_len_padded // matcher.mesh.size
    return matcher._place(np.asarray(local_bytes, np.uint8), shard_len)

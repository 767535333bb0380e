"""Data-parallel matching over several devices and processes.

Counterpart of ``pfac_tpu.dist.sharding``, with its public names and
contract: ``ShardedMatcher.match`` returns the single-device matcher's
int32[N] exactly, whatever the mesh. The reference library's multi-GPU
harness splits the input into chunks, extends each by maxPatternLen + 1
guard bytes and keeps only the first B results of each chunk
(PFAC/test/omp_PFAC.cpp:317-383); here that is a component:

* a :class:`DataMesh` lists this process's shard devices, in order (a
  device may repeat: two shards on one card), the optional
  ``torch.distributed`` group, and so each local shard's global index,
  ``rank * local_shards + i``;
* the tables are built on the host once and placed once per distinct
  device, in one single-device engine a device;
* each shard is a buffer of its own, 16-byte aligned, of ``shard_len +
  halo`` bytes, ``halo = max(max_pattern_len, 2)``; every call writes the
  first ``halo`` bytes of shard g + 1 into the tail of shard g (the last
  shard's tail is zeroed once, when it is placed), so a shard runs on its
  own bytes with nothing concatenated, and returns a view of its first
  ``shard_len`` positions;
* the match count is counted on each device by ``count_kernel``
  (``backends/count.py``; in the sieve engine's program on CUDA), summed
  on the first local device and, across processes, by ``all_reduce``
  outside the program; the heads travel in one ``all_gather`` (a few
  hundred bytes).

Engines: ``"sieve"``, a ``SieveMatcher`` a device, whose device pipeline
(``backends/pipeline.run``: K1, then K3 + compaction + K2, or compaction
+ the CSR walk) runs once a shard: on CUDA devices one program launch a
device (``backends/program.py``: every shard of the device a branch of one
CUDA graph, the count kernel after them), else ``pipeline.run`` a shard;
``"xla"``, an ``XlaMatcher`` a device,
the lockstep walker over each shard's buffer as it is (one kernel launch
a shard on CUDA), every byte at and past global position n a trap;
``"auto"``, the sieve engine on CUDA devices
and the walker on the CPU, as the reference picks the sieve on a TPU mesh
and the walker elsewhere (and the walker where the sieve's host tables
cannot be built: ``backends/select.try_build`` chooses). On the CPU the
sieve engine runs its kernels' plain versions.

One process enqueues every local device's program from one host thread,
so over several cards its host time a call grows with the cards: a mesh
of one process over several cards can be slower than one card (PERF.md),
and one process a card (``multihost``) is the layout that scales.

Not ported, because nothing needs them here: the reference's
``tail_split`` layout (it spares a concatenation that the in-place halo
never makes), ``_compact_capped`` (the device reduce,
``backends/reduce.py``, compacts each shard with no capacity, so
``reduce_cap`` is accepted and ignored, and no shard needs the dense
fallback) and the sieve-to-walker overflow fallback (the port's pipeline
has no stage capacity, so there is no overflow to catch).
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..core.automaton import Automaton
from ..status import PfacError, PfacStatus
from ..backends import count as count_mod
from ..backends import program, select
from ..backends.golden import _as_u8
from ..backends.reduce import reduce_from_dense
from ..backends.sieve_matcher import (_POS_LIMIT, TILE_ROWS, SieveMatcher,
                                      npad_for)
from ..backends.sieve_tables import LANES
from ..backends.xla import DEFAULT_TILE, XlaMatcher
from ..runtime.handle import PlacementMode

_ALIGN = 16        # K1 loads 16-byte vectors; it copies a buffer that is not


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's shard devices, in order, and the process group that
    joins it to the other processes' shards (None: this process alone).
    Every rank holds the same number of shards."""

    devices: tuple[torch.device, ...]
    group: object | None = None

    @property
    def rank(self) -> int:
        return 0 if self.group is None else self.group.rank()

    @property
    def world(self) -> int:
        return 1 if self.group is None else self.group.size()

    @property
    def local_shards(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards over every process."""
        return self.world * self.local_shards

    def global_index(self, i: int) -> int:
        return self.rank * self.local_shards + i

    def exchange_device(self) -> torch.device:
        """Where a collective's buffers live: the first local device for
        NCCL, the CPU for gloo."""
        import torch.distributed as dist

        if dist.get_backend(self.group) == "nccl":
            return self.devices[0]
        return torch.device("cpu")


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_data_mesh(num_devices: int | None = None,
                   devices=None) -> DataMesh:
    """A mesh over `devices` (default: every visible GPU), or their first
    `num_devices`. Without a GPU and without `devices` it raises: the mesh
    never takes the CPU by itself."""
    if devices is None:
        if not torch.cuda.is_available():
            raise PfacError(PfacStatus.INVALID_PARAMETER,
                            "no GPU is visible: pass the mesh's devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if num_devices is not None:
        devices = devices[:num_devices]
    if not devices:
        raise PfacError(PfacStatus.INVALID_PARAMETER, "a mesh needs a device")
    return DataMesh(tuple(devices))


def device_mesh(device="cuda", shards: int | None = None) -> DataMesh:
    """The tools' mesh: for ``"cuda"`` with no index, `shards` shards
    (default one a visible GPU) dealt round robin over the visible GPUs;
    for a device that names one (``cuda:1``, ``cpu``), `shards` (default 1)
    shards on it."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        mesh = make_data_mesh()
        if shards is None:
            return mesh
        return make_data_mesh(devices=[mesh.devices[i % len(mesh.devices)]
                                       for i in range(shards)])
    return make_data_mesh(devices=[d] * (shards or 1))


def _on(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


@dataclasses.dataclass
class ShardedMatcher:
    """Data-parallel matcher over a :class:`DataMesh`.

    ``match(data)`` returns the same int32[N] as the single-device matcher:
    sharding is invisible in the output. It holds one single-device engine
    a distinct device: a ``SieveMatcher`` (chosen by
    ``select.try_build``; the host tables built once, placed once a
    device) or an ``XlaMatcher``. `engine` is ``"auto"``, ``"sieve"``,
    ``"xla"`` or a ``SieveMatcher`` built beforehand, whose tables every
    shard then shares (on its own device, the engine itself). `tile` is the
    lockstep walker's tile, `tile_rows` the sieve engine's 128-position
    rows a bucket (default: the production 512 on CUDA, 64 on the CPU, the
    reference's interpret-mode geometry); the sieve engine's own rows win,
    those of an engine passed in or as ``select.try_build`` rounds them."""

    automaton: Automaton
    mesh: DataMesh | None = None
    perf_mode: str = "dense"
    tile: int = DEFAULT_TILE
    engine: str | SieveMatcher = "auto"
    tile_rows: int | None = None
    reduce_cap: int = 1 << 20     # accepted and ignored: the reduce has no cap

    def __post_init__(self):
        if self.mesh is None:
            self.mesh = make_data_mesh()
        a = self.automaton
        self.halo = max(a.max_pattern_len, 2)
        distinct = list(dict.fromkeys(self.mesh.devices))
        first = self.engine if isinstance(self.engine, SieveMatcher) else None
        if self.tile_rows is None:
            self.tile_rows = (TILE_ROWS if distinct[0].type == "cuda"
                              else 64)
        if first is None and (self.engine == "sieve" or self.engine == "auto"
                              and distinct[0].type == "cuda"):
            first = select.try_build(
                a, self.perf_mode, placement=PlacementMode.AUTO,
                tile=self.tile_rows * LANES, device=distinct[0],
                required=self.engine == "sieve")
        if first is not None:
            self.engine, self.tile_rows = "sieve", first.tile_rows
            host = first.tables, first.walk_tables, first.csr_tables
            self._engines = {
                d: first if d == first.device else
                SieveMatcher(a, device=d, tile_rows=self.tile_rows, host=host)
                for d in distinct}
        elif self.engine in ("auto", "xla"):
            self.engine = "xla"
            self._engines = {d: XlaMatcher(a, self.perf_mode, self.tile, d)
                             for d in distinct}
        else:
            raise ValueError(f"unknown engine {self.engine!r}")

    # ------------------------------------------------------------ internals
    @property
    def num_devices(self) -> int:
        """Shards over the whole mesh (every process)."""
        return self.mesh.size

    def _shard_len(self, n: int) -> int:
        """Bytes a shard owns: ceil(n / shards) rounded up to whole buckets
        (sieve) or tiles (walker), and never shorter than the halo, which
        comes from the next shard alone."""
        per = max(-(-n // self.num_devices), self.halo)
        if self.engine == "sieve":
            return npad_for(per, self.tile_rows)
        return max(1, -(-per // self.tile)) * self.tile

    def _check_len(self, shard_len: int) -> None:
        # same int32 position bound as SieveMatcher._run
        if npad_for(shard_len + self.halo, self.tile_rows) > _POS_LIMIT:
            raise PfacError(
                PfacStatus.INVALID_PARAMETER,
                "per-shard bytes exceed the int32 position range; use more "
                "shards or feed < 2 GiB a shard")

    def _place(self, local, shard_len: int) -> list[torch.Tensor]:
        """This process's shard buffers from its own bytes (numpy or a
        torch tensor on any device; shard i from ``local[i * shard_len:]``,
        zero-padded): each ``shard_len + halo`` bytes, 16-byte aligned, the
        halo left for the call to write."""
        self._check_len(shard_len)
        if isinstance(local, np.ndarray):
            local = np.ascontiguousarray(local, np.uint8)
            local = torch.from_numpy(local if local.flags.writeable
                                     else local.copy())
        out = []
        for i, d in enumerate(self.mesh.devices):
            lo = min(i * shard_len, local.shape[0])
            hi = min(lo + shard_len, local.shape[0])
            raw = torch.empty(shard_len + self.halo + _ALIGN,
                              dtype=torch.uint8, device=d)
            skip = -raw.data_ptr() % _ALIGN
            buf = raw[skip: skip + shard_len + self.halo]
            buf[hi - lo:].zero_()
            buf[:hi - lo].copy_(local[lo:hi])
            out.append(buf)
        return out

    def _put(self, arr, shard_len: int) -> list[torch.Tensor]:
        """The local shard buffers of the whole input `arr` (host bytes or a
        tensor)."""
        lo = self.mesh.global_index(0) * shard_len
        return self._place(arr[lo: lo + self.mesh.local_shards * shard_len],
                           shard_len)

    def _exchange_halos(self, shards: list[torch.Tensor],
                        shard_len: int) -> None:
        """Tail of shard g <- head of shard g + 1. The last shard's tail
        keeps the zeros that ``_place`` wrote."""
        h = self.halo
        mesh = self.mesh
        if mesh.group is None:
            heads = [s[:h] for s in shards[1:]]
        else:
            import torch.distributed as dist

            ex = mesh.exchange_device()
            mine = torch.cat([s[:h].to(ex) for s in shards])
            every = [torch.empty_like(mine) for _ in range(mesh.world)]
            dist.all_gather(every, mine, group=mesh.group)
            glob = torch.cat(every)       # every shard's head, in order
            heads = [glob[(g + 1) * h:(g + 2) * h] for g in
                     map(mesh.global_index, range(mesh.local_shards))]
        for s, head in zip(shards, heads):
            if head.numel():
                with _on(s.device):
                    s[shard_len:].copy_(head)

    def _n_valid(self, g: int, shard_len: int, n: int) -> int:
        """Bytes of global shard g's buffer that lie before n."""
        return min(max(n - g * shard_len, 0), shard_len + self.halo)

    def _shard_result(self, buf: torch.Tensor, g: int, shard_len: int,
                      n: int) -> torch.Tensor:
        """Shard g's int32 result over its own positions (a view)."""
        n_valid = self._n_valid(g, shard_len, n)
        dev = buf.device
        if n_valid == 0:                  # past the end: nothing to launch
            return torch.zeros(shard_len, dtype=torch.int32, device=dev)
        eng = self._engines[dev]
        with _on(dev):
            if self.engine == "sieve":
                res = eng._run(buf, n_valid,
                               npad_for(shard_len + self.halo, self.tile_rows))
            else:
                res = eng._walk(buf, n_valid, shard_len // self.tile)
        return res[:shard_len]

    def _programs(self, shards: list[torch.Tensor], shard_len: int, n: int,
                  want_count: bool):
        """The sieve engine on CUDA: one program launch a distinct device,
        its shards in order -> (each local shard's result, each device's
        count or None)."""
        npad = npad_for(shard_len + self.halo, self.tile_rows)
        on: dict[torch.device, list[int]] = {}
        for i, s in enumerate(shards):
            on.setdefault(s.device, []).append(i)
        results, parts = [None] * len(shards), []
        for dev, idx in on.items():
            with _on(dev):
                res, cnt = program.match_shards(
                    self._engines[dev], [shards[i] for i in idx],
                    [self._n_valid(self.mesh.global_index(i), shard_len, n)
                     for i in idx], npad, shard_len, want_count)
            for i, r in zip(idx, res):
                results[i] = r
            parts.append(cnt)
        return results, parts

    def _run(self, shards: list[torch.Tensor], n: int,
             want_count: bool = False):
        """-> (each local shard's int32 owned result, the global match count
        as a 0-d int64 tensor on the first local device, or None)."""
        if len(shards) != self.mesh.local_shards:
            raise PfacError(PfacStatus.INVALID_PARAMETER,
                            f"{len(shards)} shards for a mesh of "
                            f"{self.mesh.local_shards} local shards")
        shard_len = shards[0].shape[0] - self.halo
        self._check_len(shard_len)
        self._exchange_halos(shards, shard_len)
        if self.engine == "sieve" and shards[0].device.type == "cuda":
            results, parts = self._programs(shards, shard_len, n, want_count)
        else:
            results = [self._shard_result(s, self.mesh.global_index(i),
                                          shard_len, n)
                       for i, s in enumerate(shards)]
            parts = ([count_mod.count_nonzero(r) for r in results]
                     if want_count else None)
        return results, (self._count(parts) if want_count else None)

    def _count(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """Matching positions over every shard from each device's or shard's
        count (0-d int64): summed on the first local device, then over the
        process group."""
        dev0 = self.mesh.devices[0]
        if len(parts) == 1 and parts[0].device == dev0:
            count = parts[0]
        else:
            count = torch.stack([p.to(dev0, non_blocking=True)
                                 for p in parts]).sum()
        if self.mesh.group is not None:
            import torch.distributed as dist

            ex = self.mesh.exchange_device()
            total = count.to(ex)
            dist.all_reduce(total, group=self.mesh.group)
            count = total.to(dev0)
        return count

    def _single_process(self, what: str) -> None:
        if self.mesh.world > 1:
            raise PfacError(
                PfacStatus.INVALID_PARAMETER,
                f"{what} needs every shard in this process; over several "
                "processes use multihost.put_host_shards and match_device")

    # ------------------------------------------------------------ public
    def match_device(self, shards: list[torch.Tensor], n: int):
        """`shards`: this process's buffers from ``_put`` (or
        ``multihost.put_host_shards``), `n` the global input length. ->
        (each local shard's int32[shard_len] owned result on its device, the
        global match count, a 0-d int64 tensor on the first local device).
        On CUDA devices with no process group it never waits for a
        device."""
        return self._run(shards, n, want_count=True)

    def match(self, data) -> np.ndarray:
        self._single_process("match")
        arr = _as_u8(data)
        n = arr.shape[0]
        if n == 0:
            return np.zeros(0, dtype=np.int32)
        results, _ = self._run(self._put(arr, self._shard_len(n)), n)
        return np.concatenate([r.cpu().numpy() for r in results])[:n]

    def match_count(self, data) -> int:
        """Global number of matching positions."""
        arr = _as_u8(data)
        n = arr.shape[0]
        if n == 0:
            return 0
        _, count = self._run(self._put(arr, self._shard_len(n)), n,
                             want_count=True)
        return int(count)

    def match_reduce(self, data) -> tuple[np.ndarray, np.ndarray, int]:
        """Compacted (ids, positions, count), positions ascending over the
        whole input and int64: the sharded path is the one that takes
        inputs of 2 GiB and more. Each shard is compacted on its device
        (``reduce_from_dense``) and only its matches come to the host."""
        self._single_process("match_reduce")
        arr = _as_u8(data)
        n = arr.shape[0]
        if n == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.int64), 0
        shard_len = self._shard_len(n)
        results, _ = self._run(self._put(arr, shard_len), n)
        reduced = []
        for r in results:
            with _on(r.device):
                reduced.append(reduce_from_dense(r))
        counts = [int(c) for _, _, c in reduced]
        ids = [i[:c].cpu().numpy() for (i, _, _), c in zip(reduced, counts)]
        pos = [p[:c].cpu().numpy().astype(np.int64) + np.int64(g) * shard_len
               for g, ((_, p, _), c) in enumerate(zip(reduced, counts))]
        gi = np.concatenate(ids).astype(np.int32)
        gp = np.concatenate(pos)
        return gi, gp, int(gp.shape[0])

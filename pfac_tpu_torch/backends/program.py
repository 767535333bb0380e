"""One host call a match: the sieve engine's chain of kernels replayed from
a plan built once for each ``(device, npad)``, a CUDA graph
(``csrc/program.cu``).

Counterpart of the JAX package's compiled programs:
``pfac_tpu.backends.pallas_sieve.SieveMatcher._pipeline_fn`` jits
``build_pipeline`` once for each ``(npad, cap, aligned)`` and ``_dispatch``
sends the whole pipeline in one dispatch; the reduce is
``jax.jit(reduce_from_dense)``; the sharded call is one jitted
``shard_map`` and its count a second program (``pfac_tpu.dist.sharding``).
The port needs no ``cap``: K2 and the CSR walk read the survivor count on
the device.

A program launches what ``pipeline.run`` launches one wrapper at a time:
K1 (its counts zeroed just before the launch), then K3, the compaction and K2 on
the walk-table tier, or the compaction and the CSR walk on the CSR tier;
for ``match_reduce_device`` the reduce's two kernels behind them; for a
sharded call each of the device's shards as a branch of its own and, where
the call wants the count, the count kernel (``count.py``) after them all.
Its geometry is the wrappers' own (:func:`geometry`: ``sieve.placement_for``,
``pipeline.threshold``, ``compact.capacity``, ``walk.launch_plan``,
``block_walk.launch_plan``), computed once, when the program is built, and
handed to C in a :class:`Spec`; C computes the grids with the kernels' own
launch code. A call then costs two ``torch.empty`` (the result and one
scratch block, carved by the geometry's offsets; from torch's allocator,
so its stream semantics hold and no buffer is shared between calls), one ``ctypes`` call
and one increment of the program's call count (``trace``: its kernels'
launches, the positions it scans and, on the walk-table tier, whether its
K2 holds the whole walk tables, ``walk.whole_calls`` or ``walk.split_calls``,
are that count times its fixed lists, expanded where the counters are
read). Its ``compact_scan_kernel`` adds the call's survivors and escaped
blocks, its K1 the short probes, its K2 the walk steps and lane slots, and
its K3 its probes and the positions it walked, and its ``compact_kernel``
the chunks it listed word by word, to the device's counter
words (``trace.device_buffer``), on the card, each at the word the
:class:`Spec` gives it (:func:`counter_words`).

Only CUDA tensors reach a program: ``pipeline.run`` and the per-kernel
wrappers stay the CPU path and the program's reference on the card. A
program that fails to build, update or launch raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
import weakref

import torch

from .. import _build, trace
from . import block_walk, compact, pipeline
from . import reduce as reduce_mod
from . import sieve, walk
from .probe import Packed
from .sieve_tables import LANES

ALIGN = 256         # bytes: each part of the scratch starts on its own lines
TIERS = ("sieve", "walk", "csr")   # the sieve alone, walk tables, CSR


class Spec(ctypes.Structure):
    """``struct Spec`` of ``csrc/program.cu``, field for field."""

    _fields_ = [(name, ctypes.c_int32) for name in (
        "device", "shards", "npad", "block", "nblocks",
        "placement", "sieve_words", "res_off", "tier", "thresh", "capacity",
        "walk_words", "walk_nsteps", "look", "tile_cap", "k3_resident",
        "k2_resident", "csr_nsteps", "reduce", "count", "scan_word",
        "short_probes_word", "walk_word", "block_walk_word",
        "compact_word")] + [
        (name, ctypes.c_int64) for name in (
            "shard_bytes", "bits_at", "counts_at", "offsets_at", "pos_at",
            "match_at", "count_at")] + [
        (name, ctypes.c_void_p) for name in (
            "sieve_arena", "sieve_desc", "walk_arena", "walk_desc",
            "walk_records", "csr_arena", "csr_desc", "counters")]


#: the Spec's field for each kernel's first counter word, and the keys of
#: ``trace.DEVICE_KEYS`` the kernel adds to from there on, in order
COUNTERS = {"scan_word": ("survivors", "blocks_escaped"),
            "short_probes_word": ("short_probes",),
            "walk_word": ("walk_steps", "walk_slots"),
            "block_walk_word": ("block_walk_probes", "block_walk_positions"),
            "compact_word": ("compact_wordwise_chunks",)}


def counter_words() -> dict[str, int]:
    """Each kernel's first word in the device's counters, from the order of
    ``trace.DEVICE_KEYS``; raises where a kernel's keys are not next to
    each other there."""
    keys = trace.DEVICE_KEYS
    out = {}
    for field, want in COUNTERS.items():
        at = keys.index(want[0])
        if keys[at:at + len(want)] != want:
            raise ValueError(f"trace.DEVICE_KEYS must hold {want} in a row")
        out[field] = at
    return out


@dataclasses.dataclass(frozen=True)
class Geometry:
    """What a program's launches are, as the wrappers compute it, and how
    its scratch and result are laid out (bytes; -1: no such part)."""

    npad: int
    block: int
    nblocks: int
    shards: int
    reduce: bool
    count: bool
    placement: str                # K1's, sieve.placement_for
    sieve_words: int
    res_off: int
    tier: str                     # one of TIERS
    thresh: int                   # pipeline.threshold
    capacity: int                 # compact.capacity: the positions buffer
    walk_words: int               # the walk tables K2 and K3 read
    walk_nsteps: int
    look: int                     # K3's plan: lookahead, tile room, resident
    tile_cap: int
    k3_resident: int
    k2_resident: int              # K2's plan
    csr_nsteps: int
    bits_at: int                  # in a shard's part of the scratch
    counts_at: int                # K1's counts and its tile counter
    offsets_at: int
    pos_at: int
    match_at: int                 # -1: the match is the result
    shard_bytes: int
    scratch_bytes: int
    result_words: int             # int32 words of the result
    count_at: int                 # the int64 count's byte offset in it


def _carve(sizes: dict[str, int]) -> tuple[dict[str, int], int]:
    """Consecutive parts of `sizes` bytes, each rounded up to ALIGN ->
    ({part: offset}, total)."""
    at, off = {}, 0
    for name, nbytes in sizes.items():
        at[name] = off
        off += -(-nbytes // ALIGN) * ALIGN
    return at, off


def geometry(sieve_tabs: Packed, walk_tabs: Packed | None,
             csr_tabs: Packed | None, npad: int, block: int,
             device: torch.device, shards: int = 1, reduce: bool = False,
             count: bool = False) -> Geometry:
    """The program of one engine at `npad` positions a shard on `device`:
    every launch's parameters as its wrapper computes them (the walk tables
    take precedence over the CSR tables, as in pipeline.run; the escape is
    armed with the walk tables), and the parts of the scratch: the bitmap
    (npad / 8 bytes), K1's counts and the word past them (its tile
    counter), the compaction's offsets and positions, and with `reduce` the
    match (the result then holds ids, positions and the count)."""
    if npad <= 0 or npad % block or shards < 1 or (reduce and shards > 1):
        raise ValueError(f"no program for npad={npad}, block={block}, "
                         f"shards={shards}, reduce={reduce}")
    nblocks = npad // block
    tier = ("walk" if walk_tabs is not None
            else "csr" if csr_tabs is not None else "sieve")
    thresh = pipeline.threshold(walk_tabs, block)
    capacity = compact.capacity(nblocks, block, thresh) if tier != "sieve" \
        else 0
    walk_nsteps = look = tile_cap = k3_resident = k2_resident = 0
    if walk_tabs is not None:
        walk_nsteps, k2_resident = walk.launch_plan(walk_tabs, device)
        _, look, tile_cap, k3_resident = block_walk.launch_plan(
            walk_tabs, npad // block_walk.CHUNK, device)
    sizes = {"bits": npad // 8, "counts": 4 * (nblocks + 1)}
    if tier != "sieve":
        sizes.update(offsets=4 * (nblocks + 1), pos=4 * capacity)
    if reduce:
        sizes["match"] = 4 * npad
    at, shard_bytes = _carve(sizes)
    if reduce:                    # ids, positions, the count (padded)
        result_words = 2 * npad + 4
    else:                         # a match a shard, then the int64 count
        result_words = shards * npad + (2 if count else 0)
    return Geometry(
        npad=npad, block=block, nblocks=nblocks, shards=shards, reduce=reduce,
        count=count, placement=sieve.placement_for(sieve_tabs),
        sieve_words=sieve_tabs.arena.numel(),
        res_off=sieve.residual_offset(sieve_tabs), tier=tier, thresh=thresh,
        capacity=capacity,
        walk_words=0 if walk_tabs is None else walk_tabs.arena.numel(),
        walk_nsteps=walk_nsteps, look=look, tile_cap=tile_cap,
        k3_resident=k3_resident, k2_resident=k2_resident,
        csr_nsteps=0 if csr_tabs is None else len(csr_tabs.rows) - 1,
        bits_at=at["bits"], counts_at=at["counts"],
        offsets_at=at.get("offsets", -1), pos_at=at.get("pos", -1),
        match_at=at.get("match", -1), shard_bytes=shard_bytes,
        scratch_bytes=shards * shard_bytes, result_words=result_words,
        count_at=4 * shards * npad if count else -1)


def _ptr(t: Packed | None, name: str) -> int | None:
    return None if t is None else getattr(t, name).data_ptr()


class Program:
    """One engine's program at one geometry on one CUDA device: the C
    program (built at the first call, with that call's pointers, and the
    device's counter words) and what a call adds to the counters."""

    def __init__(self, geo: Geometry, sieve_tabs: Packed,
                 walk_tabs: Packed | None, csr_tabs: Packed | None,
                 device: torch.device):
        self.geo, self.device, self.index = geo, device, device.index or 0
        self.handle = ctypes.c_void_p()
        self._lock = threading.Lock()   # one build, whatever the threads
        fields = {f.name: getattr(geo, f.name)
                  for f in dataclasses.fields(geo)
                  if f.name in dict(Spec._fields_)}
        fields.update(
            device=device.index or 0, placement=sieve.PLACEMENTS.index(
                geo.placement), tier=TIERS.index(geo.tier),
            reduce=int(geo.reduce), count=int(geo.count),
            sieve_arena=_ptr(sieve_tabs, "arena"),
            sieve_desc=_ptr(sieve_tabs, "desc"),
            walk_arena=_ptr(walk_tabs, "arena"),
            walk_desc=_ptr(walk_tabs, "desc"),
            walk_records=_ptr(walk_tabs, "records"),
            csr_arena=_ptr(csr_tabs, "arena"), csr_desc=_ptr(csr_tabs, "desc"),
            **counter_words())
        self.spec = Spec(**fields)
        # the tables stay alive as long as the program that points at them
        self._tables = (sieve_tabs, walk_tabs, csr_tabs)
        #: each kernel's launches a call: its tier's once a shard, the
        #: reduce's and the count once
        k = geo.shards
        self.kernels = {f"sieve_{geo.placement}_kernel": k}
        if geo.tier != "sieve":
            self.kernels.update(dict.fromkeys(compact.KERNELS, k))
        if geo.tier == "walk":
            self.kernels.update(walk_kernel=k, block_walk_kernel=k)
        elif geo.tier == "csr":
            self.kernels["csr_walk_kernel"] = k
        if geo.reduce:
            self.kernels.update(dict.fromkeys(reduce_mod.KERNELS, 1))
        if geo.count:
            self.kernels["count_kernel"] = 1
        adds = {"launch.program": 1, "positions": k * geo.npad,
                **{f"launch.{kn}": c for kn, c in self.kernels.items()}}
        if geo.tier == "walk":      # K2 with the whole tables resident, or not
            adds["walk.whole_calls" if geo.k2_resident == geo.walk_words
                 else "walk.split_calls"] = 1
        self._tally = trace.tally(adds)

    def _counted(self, rc: int) -> None:
        self._tally.calls += 1
        _build.check(rc, "program")

    def _create(self, data, n, res, scratch, status, nstatus, epoch,
                count_len) -> None:
        with self._lock:
            if not self.handle:
                self._build(data, n, res, scratch, status, nstatus, epoch,
                            count_len)

    @trace.spanned("pfac.program.build")
    def _build(self, data, n, res, scratch, status, nstatus, epoch,
               count_len) -> None:
        lib = _build.load()
        with trace.timed("build.program_s"):
            self.spec.counters = trace.device_buffer(self.device).data_ptr()
            rc = lib.pfac_program_create(
                ctypes.byref(self.spec), data, n, res, scratch, status,
                nstatus, epoch, count_len, ctypes.byref(self.handle))
        _build.check(rc, "program build")
        trace.count("build.programs")
        self._launch = lib.pfac_program_launch
        # destroyed with the program; at exit the process frees it
        weakref.finalize(self, lib.pfac_program_destroy,
                         self.handle.value).atexit = False

    def match(self, data: torch.Tensor, n: int):
        """One shard's call on a uint8 tensor on the program's device (>= n
        bytes) -> int32[npad], or (ids, positions, count) with reduce."""
        g = self.geo
        ptr = data.data_ptr()
        if ptr % 16:
            data = data.clone()         # K1 loads 16-byte vectors
            ptr = data.data_ptr()
        dev = self.device
        res = torch.empty(g.result_words, dtype=torch.int32, device=dev)
        scratch = torch.empty(g.scratch_bytes, dtype=torch.uint8, device=dev)
        stream = torch._C._cuda_getCurrentRawStream(self.index)
        status, nstatus, epoch = None, 0, 0
        if g.reduce:
            words, epoch = reduce_mod._scratch(dev, stream,
                                               reduce_mod.tiles(g.npad) + 1)
            status, nstatus = words.data_ptr(), words.numel()
        if not self.handle:
            self._create((ctypes.c_uint64 * 1)(ptr), (ctypes.c_int32 * 1)(n),
                         res.data_ptr(), scratch.data_ptr(), status, nstatus,
                         epoch, 0)
        self._counted(self._launch(self.handle, ptr, n, res.data_ptr(),
                                   scratch.data_ptr(), status, nstatus, epoch,
                                   stream))
        if g.reduce:
            npad = g.npad
            return res[:npad], res[npad:2 * npad], res[2 * npad]
        return res

    def match_shards(self, shards: list[torch.Tensor], ns: list[int],
                     shard_len: int):
        """The device's shards (16-byte aligned uint8 buffers, `ns[i]` valid
        bytes each) -> (each shard's int32[shard_len] result, a view; the
        count of their nonzero words, a 0-d int64 tensor, or None)."""
        g = self.geo
        dev = self.device
        res = torch.empty(g.result_words, dtype=torch.int32, device=dev)
        scratch = torch.empty(g.scratch_bytes, dtype=torch.uint8, device=dev)
        data = (ctypes.c_uint64 * g.shards)(*(s.data_ptr() for s in shards))
        nvalid = (ctypes.c_int32 * g.shards)(*ns)
        if not self.handle:
            self._create(data, nvalid, res.data_ptr(), scratch.data_ptr(),
                         None, 0, 0, shard_len)
        self._counted(_build.load().pfac_program_launch_shards(
            self.handle, data, nvalid, res.data_ptr(), scratch.data_ptr(),
            shard_len, torch._C._cuda_getCurrentRawStream(self.index)))
        views = [res[i * g.npad:i * g.npad + shard_len]
                 for i in range(g.shards)]
        if not g.count:
            return views, None
        at = g.count_at // 4
        return views, res[at:at + 2].view(torch.int64)[0]


def _program(engine, key: tuple, **kw) -> Program:
    prog = engine._programs.get(key)
    return prog if prog is not None else _new_program(engine, key, **kw)


@trace.spanned("pfac.program.build")
def _new_program(engine, key: tuple, **kw) -> Program:
    _build.load()            # the library's own time is build.library_s
    with trace.timed("build.program_s"):
        dev = engine.device
        geo = geometry(engine._sieve, engine._walk, engine._csr,
                       block=engine.tile_rows * LANES, device=dev, **kw)
        return engine._programs.setdefault(key, Program(
            geo, engine._sieve, engine._walk, engine._csr, dev))


def _check(data: torch.Tensor, n: int, device: torch.device) -> None:
    if data.dtype != torch.uint8 or data.dim() != 1 or not data.is_contiguous():
        raise ValueError("data must be a contiguous 1-D uint8 tensor")
    if not 0 <= n <= data.shape[0]:
        raise ValueError(f"need 0 <= n <= len(data) (n={n}, "
                         f"len={data.shape[0]})")
    if data.device != device:
        raise ValueError(f"data is on {data.device}, the program on {device}")


@trace.spanned("pfac.program")
def match(engine, data: torch.Tensor, n: int, npad: int,
          reduce: bool = False):
    """`engine` (a SieveMatcher on a CUDA device) on the first n bytes of
    `data` -> int32[npad] as ``pipeline.run`` returns it, or with `reduce`
    (ids, positions, count) as ``reduce.reduce_from_dense`` of it; one
    program launch, its program built at the first call at this npad."""
    _check(data, n, engine.device)
    return _program(engine, (engine.device.index, npad, reduce), npad=npad,
                    reduce=reduce).match(data, n)


@trace.spanned("pfac.program")
def match_shards(engine, shards: list[torch.Tensor], ns: list[int],
                 npad: int, shard_len: int, count: bool):
    """The shards on `engine`'s device, each run as ``pipeline.run(shard,
    ns[i], npad)``, in one program launch -> (each shard's first
    `shard_len` positions, a view; with `count` the number of their
    nonzero words, a 0-d int64 tensor, else None)."""
    for s, n in zip(shards, ns):
        _check(s, n, engine.device)
        if s.data_ptr() % 16:
            raise ValueError("a shard buffer must be 16-byte aligned")
    if not 0 < shard_len <= npad:
        raise ValueError(f"need 0 < shard_len <= npad ({shard_len}, {npad})")
    key = (engine.device.index, npad, len(shards), count)
    return _program(engine, key, npad=npad, shards=len(shards),
                    count=count).match_shards(shards, ns, shard_len)

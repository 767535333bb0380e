"""Survivor walk: kernel K2 and its plain torch version.

K2 (``csrc/walk.cu``) replaces the Pallas survivor walker
``pfac_tpu.backends.pallas_walk._make_walk_kernel``. It walks every
survivor position to full depth over the depth-sliced exact tables
(``walk_tables.py``) and writes ``out[pos] = id`` of the longest match of
>= 4 bytes, only where there is one. The sieve already wrote the exact
depth-1..3 match at every position, and a match of >= 4 bytes is always
longer, so the walk updates the sieve's result in place.

The positions may come in a buffer longer than the survivors, with their
number in a 1-element device tensor (the compaction's total): the kernel
reads the count on the device, so the host never waits for it. The kernel
runs on a persistent grid whose lanes take the next survivor as soon as a
walk ends, with its records (a loop iteration's three probes, derived from
the descriptor rows: ``walk_tables.walk_records``) and, by depth, as much of
its tables as fits (:func:`resident_words`) in shared memory.

K2, K3 and the plain versions read the walk tables in their one layout
(``walk_tables.pack_walk``): keys and displacements in words, values in
16-bit half-words, which the encoding allows (``walk_tables.DEAD``). The
Snort-scale set's tables (199,856 B) fit K2's shared memory whole, so K2
probes no table through L1/L2 there (:func:`launch_plan`); a larger
ruleset keeps the longest prefix of whole tables that fits. Through a
program K2 counts its loop iterations on the card (``trace``'s
``walk_steps`` and ``walk_slots``; :func:`walk_steps_plain` recounts the
steps on the host), and the program counts its calls whose K2 holds the
whole tables (``walk.whole_calls``) or a prefix (``walk.split_calls``);
the wrapper :func:`walk` counts nothing.
"""
from __future__ import annotations

import bisect
import ctypes

import torch

from .. import _build, trace
from .probe import Packed, slot, unsigned
from .sieve import SMEM_LIMIT
from .walk_tables import DEAD, RECORD_WORDS

_HEADER = 16                # the tables' mbarrier, as csrc/walk.cu


def steps_of(tabs: Packed) -> int:
    return (len(tabs.rows) - 2) // 3


def table_ends(tabs: Packed) -> list[int]:
    """Words of the walk tables at which a whole table (one present
    descriptor row's arrays) ends, ascending: the layout holds entry,
    entry_final, then every step's main, odd, even (``pack_walk``)."""
    return tabs.derived["table_ends"]


def resident_words(tabs: Packed, budget: int) -> int:
    """Words of the walk tables a walk kernel (K2, K3) keeps in shared
    memory: the longest prefix of whole tables within `budget` bytes, 0
    when not even the entry table fits. The kernels read every word past
    it through L1/L2."""
    if budget < 0:
        raise ValueError(f"a negative shared-memory budget ({budget} bytes): "
                         "the kernel's fixed part does not fit")
    ends = table_ends(tabs)
    k = bisect.bisect_right(ends, budget // 4)
    return ends[k - 1] if k else 0


def fixed_smem_bytes(nsteps: int) -> int:
    """K2's dynamic shared memory without the resident tables
    (csrc/walk.cu): its header and a record a loop iteration."""
    return _HEADER + 4 * RECORD_WORDS * (nsteps + 1)


def launch_plan(tabs: Packed, device: torch.device) -> tuple[int, int]:
    """(nsteps, resident words) of a K2 launch: the whole tables where they
    fit beside the records, else their longest prefix of whole
    tables that does; kept with the tables."""
    key = ("k2_plan", device.index)
    plan = tabs.derived.get(key)
    if plan is None:
        nsteps = steps_of(tabs)
        plan = tabs.derived[key] = (nsteps, resident_words(
            tabs, SMEM_LIMIT - fixed_smem_bytes(nsteps)))
    return plan


def grid(tabs: Packed, device: torch.device) -> int:
    """CTAs of K2's persistent grid for these tables on a CUDA device."""
    nsteps, resident = launch_plan(tabs, device)
    out = ctypes.c_int64()
    _build.check(_build.load().pfac_walk_grid(
        device.index or 0, nsteps, resident, tabs.arena.numel(),
        ctypes.byref(out)), "walk_kernel grid")
    return out.value


def _check(data, n, pos, out, tabs: Packed, count=None) -> None:
    if data.dtype != torch.uint8 or data.dim() != 1 or not data.is_contiguous():
        raise ValueError("data must be a contiguous 1-D uint8 tensor")
    if not 0 <= n <= data.shape[0] or out.shape[0] < n:
        raise ValueError("need n <= len(data) and n <= len(out)")
    if pos.dtype != torch.int32 or pos.dim() != 1 or not pos.is_contiguous():
        raise ValueError("positions must be a contiguous 1-D int32 tensor")
    if out.dtype != torch.int32 or out.dim() != 1 or not out.is_contiguous():
        raise ValueError("out must be a contiguous 1-D int32 tensor")
    if count is not None and (count.dtype != torch.int32 or count.numel() != 1
                              or not count.is_contiguous()):
        raise ValueError("count must be a contiguous 1-element int32 tensor")
    for t in (pos, out, tabs.arena, tabs.records, count):
        if t is not None and t.device != data.device:
            raise ValueError("all tensors must be on the data's device")


def walk(data: torch.Tensor, n: int, pos: torch.Tensor, out: torch.Tensor,
         tabs: Packed, count: torch.Tensor | None = None) -> None:
    """Walk the first `count` positions of `pos` (all of them without a
    count; each < n) and write the longest match of >= 4 bytes into `out`
    in place. A CPU tensor runs the plain version; a CUDA tensor launches
    K2, which reads `count` on the device, once whatever the count."""
    _check(data, n, pos, out, tabs, count)
    if data.device.type == "cpu":
        return walk_plain(data, n, pos, out, tabs, count)
    if data.device.type != "cuda":
        raise ValueError(f"no walker for device {data.device}")
    nsteps, resident = launch_plan(tabs, data.device)
    rc = _build.load().pfac_walk(
        data.device.index or 0, data.data_ptr(), n, pos.data_ptr(),
        None if count is None else count.data_ptr(), pos.shape[0],
        tabs.arena.data_ptr(), tabs.arena.numel(), resident,
        tabs.records.data_ptr(), nsteps, out.data_ptr(),
        torch.cuda.current_stream(data.device).cuda_stream)
    trace.count("launch.walk_kernel")
    _build.check(rc, "walk_kernel")
    return None


def walk_plain(data: torch.Tensor, n: int, pos: torch.Tensor,
               out: torch.Tensor, tabs: Packed,
               count: torch.Tensor | None = None) -> None:
    """Plain torch version of K2, on the data's device: the first `count`
    positions of `pos`, or all of them."""
    p, match, _ = _plain(data, n, pos, tabs, count)
    deep = match > 0
    out[p[deep]] = match[deep].to(torch.int32)
    return None


def walk_steps_each_plain(data: torch.Tensor, n: int, pos: torch.Tensor,
                          tabs: Packed,
                          count: torch.Tensor | None = None) -> torch.Tensor:
    """K2's loop iterations for each walked position (int64, in `pos`'s
    order): the entry probe, then one a step the walk was alive at; a walk
    ends on a missing state (DEAD), at a step with no main table, where n
    cuts it, or after the last step."""
    return _plain(data, n, pos, tabs, count)[2]


def walk_steps_plain(data: torch.Tensor, n: int, pos: torch.Tensor,
                     tabs: Packed, count: torch.Tensor | None = None) -> int:
    """The ``walk_steps`` a program's K2 adds for these positions: the sum
    of :func:`walk_steps_each_plain`."""
    return int(walk_steps_each_plain(data, n, pos, tabs, count).sum())


def alive_trail_plain(data: torch.Tensor, n: int, pos: torch.Tensor,
                      tabs: Packed) -> list[torch.Tensor]:
    """For each step the plain walk reaches with a position alive, which of
    `pos` are alive as it starts (a bool tensor a step, in `pos`'s order):
    K3 steps a batch of positions as long as two of them are."""
    trail: list[torch.Tensor] = []
    _plain(data, n, pos, tabs, None, trail)
    return trail


def _plain(data: torch.Tensor, n: int, pos: torch.Tensor, tabs: Packed,
           count: torch.Tensor | None, trail: list | None = None):
    """The plain walk -> (positions as int64, the longest match of >= 4
    bytes at each (0: none), K2's loop iterations for each). With `trail`,
    appends for each step the walk reaches with a position alive which
    positions are alive as it starts (a bool tensor a step)."""
    if count is not None:
        pos = pos[:int(count)]
    p = pos.to(torch.int64)
    maxd = n - p

    def byte(j: int) -> torch.Tensor:
        q = torch.clamp(p + j, max=max(n - 1, 0))
        return torch.where(maxd > j, data[q].to(torch.int64), 0)

    rows = tabs.rows
    words = unsigned(tabs.arena)        # keys and displacements
    halves = tabs.arena.view(torch.int16).to(torch.int64) & 0xFFFF

    def lookup(row, key):               # as the kernels read the tables
        at = slot(words, row, key)
        return words[row[4] + at] == key, halves[row[5] + at]

    key4 = (byte(0) << 24) | (byte(1) << 16) | (byte(2) << 8) | byte(3)
    ok4 = maxd > 3
    hit, idx = lookup(rows[0], key4)
    state = torch.where(hit & ok4, idx, DEAD)
    match = torch.zeros_like(p)
    iters = torch.ones_like(p)          # the entry probe
    if rows[1][6]:
        hit, pid = lookup(rows[1], key4)
        match = torch.where(hit & ok4, pid, match)
    steps = rows[2:]
    for s in range(len(steps) // 3):
        main, odd, even = steps[3 * s: 3 * s + 3]
        alive = state != DEAD
        if not bool(alive.any()):
            break                       # a DEAD state never hits again
        if trail is not None:
            trail.append(alive)
        iters += alive
        d = 4 + 2 * s
        c1 = byte(d)
        if odd[6]:
            hit, pid = lookup(odd, (state << 8) | c1)
            match = torch.where(hit & (maxd > d), pid, match)
        if not main[6]:
            break                       # no deeper states exist
        mkey = (state << 16) | (c1 << 8) | byte(d + 1)
        hit, nxt = lookup(main, mkey)
        hit = hit & (maxd > d + 1)
        if even[6]:
            ehit, pid = lookup(even, mkey)
            match = torch.where(ehit & (maxd > d + 1), pid, match)
        state = torch.where(hit, nxt, DEAD)
    return p, match, iters

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
walk ends, with the descriptor rows and, by depth, as much of its tables as
fits (:func:`resident_words`) in shared memory.

K2 reads the tables from an image of its own (:func:`image`, built once
and kept with the tables; the engine builds it at upload): the same
tables in the same order, each value array stored in 16 bits, which the
encoding allows (``walk_tables.DEAD``). The Snort-scale set's image
(199,856 B against the arena's 260,832) fits shared memory whole, so K2
probes no table through L1/L2 there (:func:`launch_plan`); a larger
ruleset keeps a longer prefix than the arena would. K3, the CSR walk and
the plain versions read the arena; :func:`image_walk_plain` walks the image
on the host. Through a program K2 counts its loop iterations on the card
(``trace``'s ``walk_steps`` and ``walk_slots``; :func:`walk_steps_plain`
recounts the steps on the host), and the program counts its calls whose K2
holds the whole image (``walk.whole_calls``) or a prefix
(``walk.split_calls``); the wrapper :func:`walk` counts nothing.
"""
from __future__ import annotations

import bisect
import ctypes

import numpy as np
import torch

from .. import _build, trace
from .probe import DESC_WORDS, Packed, desc_array, probe, slot, unsigned
from .sieve import SMEM_LIMIT
from .walk_tables import DEAD

_HEADER = 16                # the tables' mbarrier, as csrc/walk.cu


def steps_of(tabs: Packed) -> int:
    return (len(tabs.rows) - 2) // 3


def table_ends(tabs: Packed) -> list[int]:
    """Arena offsets at which a whole table (one descriptor row's arrays)
    ends, ascending. pack() lays the arena in row order: entry,
    entry_final, then every step's main, odd, even."""
    ends = tabs.derived.get("table_ends")
    if ends is None:
        ends = []
        for _, lg_b, lg_r, disp_off, key_off, val_off, present, _ in tabs.rows:
            if present:
                ends.append(max(disp_off + (1 << lg_b) if disp_off >= 0 else 0,
                                key_off + (1 << lg_r), val_off + (1 << lg_r)))
        if ends != sorted(ends) or (ends and ends[-1] != tabs.arena.numel()):
            raise ValueError("the walk arena is not laid out in row order")
        tabs.derived["table_ends"] = ends
    return ends


def resident_words(tabs: Packed, budget: int) -> int:
    """Words of the arena a walk kernel (K2, K3) keeps in shared memory: the
    longest prefix of whole tables within `budget` bytes, 0 when not even
    the entry table fits. The kernels read every word past it through
    L1/L2."""
    if budget < 0:
        raise ValueError(f"a negative shared-memory budget ({budget} bytes): "
                         "the kernel's fixed part does not fit")
    ends = table_ends(tabs)
    k = bisect.bisect_right(ends, budget // 4)
    return ends[k - 1] if k else 0


def fixed_smem_bytes(nsteps: int) -> int:
    """K2's dynamic shared memory without the resident tables
    (csrc/walk.cu): its header and the descriptor rows."""
    return _HEADER + 4 * DESC_WORDS * (2 + 3 * nsteps)


_ALIGN_HALVES = 8           # each array of the image starts on 16 bytes


def image(tabs: Packed) -> Packed:
    """K2's image of the walk tables, built on the host from the arena at
    the first use and kept with the tables: the same rows in the same
    order, each table's displacements and keys as 32-bit words and its
    values as 16-bit half-words, every array padded to 16 bytes (so the
    bulk copy takes any prefix of whole tables). Its rows give the
    displacements' and keys' offsets in words and the values' in
    half-words of the image (``arena``, int32 words; half-word h is the low
    half of word h // 2 where h is even, as the card reads it);
    ``derived["table_ends"]`` holds the word at which each table ends.
    Raises ValueError on a value of 2^16 or more, which the encoding
    forbids."""
    img = tabs.derived.get("k2_image")
    if img is None:
        img = tabs.derived["k2_image"] = _build_image(tabs)
    return img


def _build_image(tabs: Packed) -> Packed:
    a = tabs.arena.cpu().numpy()
    parts: list[np.ndarray] = []
    off = 0                                   # half-words

    def put(halves: np.ndarray) -> int:
        nonlocal off
        pad = -halves.size % _ALIGN_HALVES
        parts.extend((halves, np.zeros(pad, np.uint16)))
        start, off = off, off + halves.size + pad
        return start

    rows, ends = [], []
    for mul, lg_b, lg_r, disp_off, key_off, val_off, present, _ in tabs.rows:
        if not present:
            rows.append((0, 0, 0, -1, -1, -1, 0, 0))
            continue
        r = 1 << lg_r
        vals = a[val_off:val_off + r].view(np.uint32)
        if int(vals.max()) >= 1 << 16:
            raise ValueError(f"a walk-table value of {int(vals.max())} does "
                             "not fit K2's 16-bit image")
        disp = (-1 if disp_off < 0 else
                put(a[disp_off:disp_off + (1 << lg_b)].view(np.uint16)) // 2)
        keys = put(a[key_off:key_off + r].view(np.uint16)) // 2
        rows.append((mul, lg_b, lg_r, disp, keys,
                     put(vals.astype(np.uint16)), 1, 0))
        ends.append(off // 2)
    words = np.concatenate(parts).view(np.int32)
    dev = tabs.arena.device
    return Packed(arena=torch.from_numpy(words).to(dev),
                  desc=torch.from_numpy(desc_array(rows)).to(dev), rows=rows,
                  derived={"table_ends": ends})


def launch_plan(tabs: Packed, device: torch.device) -> tuple[int, int]:
    """(nsteps, resident words of the :func:`image`) of a K2 launch: the
    whole image where it fits beside the descriptor rows, else its longest
    prefix of whole tables that does; kept with the tables."""
    key = ("k2_plan", device.index)
    plan = tabs.derived.get(key)
    if plan is None:
        nsteps = steps_of(tabs)
        plan = tabs.derived[key] = (nsteps, resident_words(
            image(tabs), SMEM_LIMIT - fixed_smem_bytes(nsteps)))
    return plan


def grid(tabs: Packed, device: torch.device) -> int:
    """CTAs of K2's persistent grid for these tables on a CUDA device."""
    nsteps, resident = launch_plan(tabs, device)
    out = ctypes.c_int64()
    _build.check(_build.load().pfac_walk_grid(
        device.index or 0, nsteps, resident, image(tabs).arena.numel(),
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
    for t in (pos, out, tabs.arena, tabs.desc, count):
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
    img = image(tabs)
    rc = _build.load().pfac_walk(
        data.device.index or 0, data.data_ptr(), n, pos.data_ptr(),
        None if count is None else count.data_ptr(), pos.shape[0],
        img.arena.data_ptr(), img.arena.numel(), resident,
        img.desc.data_ptr(), nsteps, out.data_ptr(),
        torch.cuda.current_stream(data.device).cuda_stream)
    trace.count("launch.walk_kernel")
    _build.check(rc, "walk_kernel")
    return None


def walk_plain(data: torch.Tensor, n: int, pos: torch.Tensor,
               out: torch.Tensor, tabs: Packed,
               count: torch.Tensor | None = None) -> None:
    """Plain torch version of K2, on the data's device: the first `count`
    positions of `pos`, or all of them."""
    p, match, _ = _plain(data, n, pos, tabs.rows, _arena_lookup(tabs), count)
    deep = match > 0
    out[p[deep]] = match[deep].to(torch.int32)
    return None


def image_walk_plain(data: torch.Tensor, n: int, pos: torch.Tensor,
                     out: torch.Tensor, img: Packed,
                     count: torch.Tensor | None = None) -> None:
    """:func:`walk_plain` reading K2's :func:`image` as the kernel does:
    keys and displacements as words, values as half-words."""
    p, match, _ = _plain(data, n, pos, img.rows, _image_lookup(img), count)
    deep = match > 0
    out[p[deep]] = match[deep].to(torch.int32)
    return None


def _arena_lookup(tabs: Packed):
    a = unsigned(tabs.arena)
    return lambda row, key: probe(a, row, key)


def _image_lookup(img: Packed):
    a = unsigned(img.arena)
    halves = img.arena.view(torch.int16).to(torch.int64) & 0xFFFF

    def lookup(row, key):
        s = slot(a, row, key)
        return a[row[4] + s] == key, halves[row[5] + s]
    return lookup


def walk_steps_each_plain(data: torch.Tensor, n: int, pos: torch.Tensor,
                          tabs: Packed,
                          count: torch.Tensor | None = None) -> torch.Tensor:
    """K2's loop iterations for each walked position (int64, in `pos`'s
    order): the entry probe, then one a step the walk was alive at; a walk
    ends on a missing state (DEAD), at a step with no main table, where n
    cuts it, or after the last step."""
    return _plain(data, n, pos, tabs.rows, _arena_lookup(tabs), count)[2]


def walk_steps_plain(data: torch.Tensor, n: int, pos: torch.Tensor,
                     tabs: Packed, count: torch.Tensor | None = None) -> int:
    """The ``walk_steps`` a program's K2 adds for these positions: the sum
    of :func:`walk_steps_each_plain`."""
    return int(walk_steps_each_plain(data, n, pos, tabs, count).sum())


def _plain(data: torch.Tensor, n: int, pos: torch.Tensor, rows: list,
           lookup, count: torch.Tensor | None):
    """The plain walk over descriptor rows whose exact probe is
    `lookup(row, key) -> (hit, value)` -> (positions as int64, the longest
    match of >= 4 bytes at each (0: none), K2's loop iterations for
    each)."""
    if count is not None:
        pos = pos[:int(count)]
    p = pos.to(torch.int64)
    maxd = n - p

    def byte(j: int) -> torch.Tensor:
        q = torch.clamp(p + j, max=max(n - 1, 0))
        return torch.where(maxd > j, data[q].to(torch.int64), 0)

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

"""CSR walk: the counterpart of kernel K4 with the walk around it, and its
plain torch version.

The kernel (``csrc/csr_walk.cu``) replaces the Pallas word-align kernel
``pfac_tpu.backends.pallas_walk._make_align_kernel`` together with the XLA
CSR walk of ``pfac_tpu.backends.xla_csr`` (``_entry_probe``,
``_probe_step``). It walks every survivor position over the CSR tables
(``csr_tables.py``) and writes ``out[pos] = id`` of the longest match of
>= 4 bytes, only where there is one; the result equals
``xla_csr.csr_oracle_walk`` at every position. As K2 does, it reads the
survivor count on the device, on a persistent grid whose lanes take the
next survivor as soon as a walk ends.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, trace
from .csr_tables import _NEXT_MASK, ENTRY_MUL, W_ENTRIES
from .probe import Packed, mul32, unsigned
from .walk import _check

def csr_walk(data: torch.Tensor, n: int, pos: torch.Tensor, out: torch.Tensor,
             tabs: Packed, count: torch.Tensor | None = None) -> None:
    """Walk the first `count` positions of `pos` (all of them without a
    count; each < n) and write the longest match of >= 4 bytes into `out`
    in place. A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel, which reads `count` on the device, once whatever the
    count."""
    _check(data, n, pos, out, tabs, count)
    if data.device.type == "cpu":
        return csr_walk_plain(data, n, pos, out, tabs, count)
    if data.device.type != "cuda":
        raise ValueError(f"no CSR walker for device {data.device}")
    rc = _build.load().pfac_csr_walk(
        data.device.index or 0, data.data_ptr(), n, pos.data_ptr(),
        None if count is None else count.data_ptr(), pos.shape[0],
        tabs.arena.data_ptr(), tabs.desc.data_ptr(), len(tabs.rows) - 1,
        out.data_ptr(), torch.cuda.current_stream(data.device).cuda_stream)
    trace.count("launch.csr_walk_kernel")
    _build.check(rc, "csr_walk_kernel")
    return None


def grid(tabs: Packed, device: torch.device) -> int:
    """CTAs of the CSR walk's persistent grid for these tables on a CUDA
    device."""
    out = ctypes.c_int64()
    _build.check(_build.load().pfac_csr_walk_grid(
        device.index or 0, len(tabs.rows) - 1, ctypes.byref(out)),
        "csr_walk_kernel grid")
    return out.value


def csr_walk_plain(data: torch.Tensor, n: int, pos: torch.Tensor,
                   out: torch.Tensor, tabs: Packed,
                   count: torch.Tensor | None = None) -> None:
    """Plain torch version of the CSR walk, on the data's device: the first
    `count` positions of `pos`, or all of them; int64 arithmetic, keys
    compared as uint32."""
    if count is not None:
        pos = pos[:int(count)]
    a = unsigned(tabs.arena)
    p = pos.to(torch.int64)
    maxd = n - p

    def word(j: int) -> torch.Tensor:
        w = torch.zeros_like(p)
        for k in range(4):
            q = torch.clamp(p + j + k, max=max(n - 1, 0))
            w = (w << 8) | torch.where(maxd > j + k, data[q].to(torch.int64), 0)
        return w

    entry_off, lgb, width, _ = tabs.rows[0]
    key4 = word(0)
    base = entry_off + (mul32(key4, ENTRY_MUL) >> (32 - lgb)) * 3 * width
    state = torch.zeros_like(p)
    match = torch.zeros_like(p)
    found = maxd < 4
    for j in range(width):
        meta = a[base + 3 * j + 1]
        hit = ~found & (meta >> 28 == 1) & (a[base + 3 * j] == key4)
        state = torch.where(hit, meta & _NEXT_MASK, state)
        pid = a[base + 3 * j + 2]
        match = torch.where(hit & (pid != 0), pid, match)
        found = found | hit
    for off, nrows, d, chain in tabs.rows[1:]:
        if not bool((state != 0).any()):
            break
        w4 = word(d)
        best_k = torch.zeros_like(p)
        best_pid = torch.zeros_like(p)
        nxt = torch.zeros_like(p)
        cur = state
        for _ in range(chain + 1):
            live = (cur != 0) & (cur < nrows)
            row = off + torch.where(live, cur, 0) * 3 * W_ENTRIES
            cont = torch.zeros_like(p)
            for j in range(W_ENTRIES):
                key, meta, pid = (a[row + 3 * j + i] for i in range(3))
                klen, nx = meta >> 28, meta & _NEXT_MASK
                cont = torch.where(live & (klen == 0) & (nx != 0), nx, cont)
                shift = 8 * (4 - torch.clamp(klen, 1, 4))
                hit = (live & (klen >= 1) & (klen <= 4) & (maxd >= d + klen)
                       & ((w4 >> shift) == key))
                upd = hit & (pid != 0) & (klen >= best_k)
                best_k = torch.where(upd, klen, best_k)
                best_pid = torch.where(upd, pid, best_pid)
                nxt = torch.where(hit & (klen == 4) & (nx != 0), nx, nxt)
            cur = cont
        match = torch.where(best_pid != 0, best_pid, match)
        state = nxt
    deep = match != 0
    out[p[deep]] = match[deep].to(torch.int32)
    return None

"""Sieve stage: kernel K1, its plain torch version, and survivor compaction.

K1 (``csrc/sieve.cu``) replaces the Pallas sieve kernel
``pfac_tpu.backends.pallas_sieve._make_kernel``. For every position
``pos < npad`` it writes ``match[pos]``, the exact ID of the longest pattern
of length 1-3 starting there (0 at and past n), and ``flags[pos] = 1`` where
the resid16 alive filter passes the 4-byte little-endian key and
``n - pos > 3``: a pattern of >= 4 bytes may start there (false positives
~2^-16, never a false negative). Survivors are walked by K2 (``walk.py``).
It also counts the survivors of every ``block``-position block
(``counts[pos // block]``), from which the dense-block escape
(``block_walk.py``) picks the blocks it walks whole.

Compaction replaces the reference's bitmap ``_compact`` and its MXU prefix
sums: ``torch.nonzero`` over the flags gives the survivor positions in
ascending order, with integer arithmetic throughout.
"""
from __future__ import annotations

import torch

from .. import _build
from .probe import MIX_RESID, Packed, mul32, probe, slot, unsigned
from .sieve_tables import LANES

#: K1 launches since the count was last reset (only where the kernel runs)
LAUNCHES = 0

_PLAIN_CHUNK = 1 << 22      # positions per pass of the plain version
BLOCK = 512 * LANES         # positions per survivor count: the 64K bucket


def _check(data: torch.Tensor, n: int, npad: int, tabs: Packed,
           block: int) -> None:
    if data.dtype != torch.uint8 or data.dim() != 1 or not data.is_contiguous():
        raise ValueError("data must be a contiguous 1-D uint8 tensor")
    if not 0 <= n <= data.shape[0] or npad < n or npad % block or block % 8192:
        raise ValueError(f"need 0 <= n <= len(data), n <= npad, "
                         f"npad % block == 0, block % 8192 == 0 "
                         f"(n={n}, len={data.shape[0]}, npad={npad}, "
                         f"block={block})")
    for t in (tabs.arena, tabs.desc):
        if t.device != data.device or t.dtype != torch.int32:
            raise ValueError("tables must be int32 on the data's device")


def sieve(data: torch.Tensor, n: int, npad: int, tabs: Packed,
          block: int = BLOCK):
    """-> (match int32[npad], flags uint8[npad], counts int32[npad // block]).
    A CPU tensor runs the plain version; a CUDA tensor launches K1."""
    _check(data, n, npad, tabs, block)
    if data.device.type == "cpu":
        return sieve_plain(data, n, npad, tabs, block)
    if data.device.type != "cuda":
        raise ValueError(f"no sieve for device {data.device}")
    global LAUNCHES
    if data.data_ptr() % 4:
        data = data.clone()             # the kernel loads 4-byte words
    match = torch.empty(npad, dtype=torch.int32, device=data.device)
    flags = torch.empty(npad, dtype=torch.uint8, device=data.device)
    counts = torch.zeros(npad // block, dtype=torch.int32, device=data.device)
    lib = _build.load()
    rc = lib.pfac_sieve(
        data.device.index or 0, data.data_ptr(), n, npad,
        tabs.arena.data_ptr(), tabs.desc.data_ptr(),
        match.data_ptr(), flags.data_ptr(), counts.data_ptr(), block,
        torch.cuda.current_stream(data.device).cuda_stream)
    LAUNCHES += 1
    _build.check(rc, "sieve_kernel")
    return match, flags, counts


def sieve_plain(data: torch.Tensor, n: int, npad: int, tabs: Packed,
                block: int = BLOCK):
    """Plain torch version of K1, on the data's device."""
    dev = data.device
    ext = torch.zeros(npad + 3, dtype=torch.uint8, device=dev)
    ext[:n] = data[:n]                  # bytes at and past n read as 0
    a = unsigned(tabs.arena)
    m2, m3, al = tabs.rows
    match = torch.empty(npad, dtype=torch.int32, device=dev)
    flags = torch.empty(npad, dtype=torch.uint8, device=dev)
    for c0 in range(0, npad, _PLAIN_CHUNK):
        c1 = min(npad, c0 + _PLAIN_CHUNK)
        pos = torch.arange(c0, c1, device=dev)
        k4 = sum(ext[c0 + k:c1 + k].to(torch.int64) << (8 * k)
                 for k in range(4))
        rd = n - pos
        m = a[k4 & 0xFF]                            # m1 sits at offset 0
        if m2[6]:
            hit, v = probe(a, m2, k4 & 0xFFFF)
            m = torch.where(hit & (rd > 1), v, m)
        if m3[6]:
            hit, v = probe(a, m3, k4 & 0xFFFFFF)
            m = torch.where(hit & (rd > 2), v, m)
        match[c0:c1] = torch.where(rd > 0, m, 0).to(torch.int32)
        f = torch.zeros_like(pos, dtype=torch.bool)
        if al[6]:
            r16 = a[al[5] + slot(a, al, k4)]
            f = (r16 == (mul32(k4, MIX_RESID) >> 16)) & (rd > 3)
        flags[c0:c1] = f.to(torch.uint8)
    counts = flags.view(-1, block).sum(1, dtype=torch.int32)
    return match, flags, counts


def compact(flags: torch.Tensor) -> torch.Tensor:
    """Survivor positions, ascending, as int32."""
    return torch.nonzero(flags).reshape(-1).to(torch.int32)

"""Sieve stage: kernel K1 and its plain torch version.

K1 (``csrc/sieve.cu``) replaces the Pallas sieve kernel
``pfac_tpu.backends.pallas_sieve._make_kernel``. For every position
``pos < npad`` it writes ``match[pos]``, the exact ID of the longest pattern
of length 1-3 starting there (0 at and past n), and sets bit ``pos % 32``
of the survivor bitmap word ``bits[pos // 32]`` where the resid16 alive
filter passes the 4-byte little-endian key and ``n - pos > 3``: a pattern
of >= 4 bytes may start there (false positives ~2^-16, never a false
negative). It also counts the survivors of every ``block``-position block
(``counts[pos // block]``), from which the dense-block escape
(``block_walk.py``) picks the blocks it walks whole and the compaction
(``compact.py``) places each block's survivors.

K1 probes the 2- and 3-byte tables only where a probe can hit: where some
pattern of that length starts with the position's byte (the gates it sets
in its staged copy of m1, :func:`gated_m1`) and fits before n, and reads a
value only on a key hit. Given a program's counter words it adds the probes
it issued (``trace``'s ``short_probes``; :func:`short_probes_plain`
recounts them). The result does not depend on the gates.

The wrapper places the tables by their size (:func:`placement_for`), one
kernel for each placement: the whole arena in each CTA's shared memory
(``smem``, the Snort-scale arena); every table but the alive residuals in
each CTA's shared memory and the residuals split across a 2-CTA cluster
(``cluster``, the 100K-signature arena); or the tables read through L1/L2
(``global``). A placement whose tables do not fit raises; nothing falls
back.
"""
from __future__ import annotations

import torch

from .. import _build, trace
from .probe import MIX_RESID, Packed, mul32, probe, slot, unsigned
from .sieve_tables import LANES

PLACEMENTS = ("smem", "cluster", "global")
#: K1's kernels, one a placement (counted as ``launch.<kernel>`` in
#: ``trace``, only where a kernel runs)
KERNELS = tuple(f"sieve_{p}_kernel" for p in PLACEMENTS)

_PLAIN_CHUNK = 1 << 22      # positions per pass of the plain version
BLOCK = 512 * LANES         # positions per survivor count: the 64K bucket
SMEM_LIMIT = 232_448 - 64   # a CTA's dynamic shared memory, less static
_WARP_STAGE = 4 * 512       # bytes of match staging per warp
_WARPS = {"smem": 8, "cluster": 16, "global": 8}   # as csrc/sieve.cu
#: the gates K1 sets in its staged m1 words (csrc/sieve.cu): an m2 key, an
#: m3 key starts with the word's byte; the IDs lie below them (< 2^30)
GATE2, GATE3 = 1 << 30, 1 << 31


def residual_offset(tabs: Packed) -> int:
    """Arena offset of the packed alive residuals (the last array), or the
    arena's length without an alive filter."""
    al = tabs.rows[2]
    return al[5] if al[6] else tabs.arena.numel()


def smem_bytes(placement: str, tabs: Packed) -> int:
    """Dynamic shared memory K1 needs for these tables (csrc/sieve.cu)."""
    words, res = tabs.arena.numel(), residual_offset(tabs)
    table = {"smem": words, "cluster": res + (words - res + 1) // 2,
             "global": 0}[placement]
    return _WARPS[placement] * _WARP_STAGE + 4 * table


def placement_for(tabs: Packed) -> str:
    """The whole arena in shared memory where it fits, else the residuals
    split across a 2-CTA cluster where that fits, else through L1/L2."""
    if smem_bytes("smem", tabs) <= SMEM_LIMIT:
        return "smem"
    if tabs.rows[2][6] and smem_bytes("cluster", tabs) <= SMEM_LIMIT:
        return "cluster"
    return "global"


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
          block: int = BLOCK, placement: str | None = None):
    """-> (match int32[npad], bits int32[npad // 32], counts
    int32[npad // block]). A CPU tensor runs the plain version; a CUDA
    tensor launches K1 with the tables placed by `placement`
    (:func:`placement_for` when None)."""
    _check(data, n, npad, tabs, block)
    if data.device.type == "cpu":
        return sieve_plain(data, n, npad, tabs, block)
    if data.device.type != "cuda":
        raise ValueError(f"no sieve for device {data.device}")
    placement = placement or placement_for(tabs)
    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}")
    if smem_bytes(placement, tabs) > SMEM_LIMIT or (
            placement == "cluster" and not tabs.rows[2][6]):
        raise ValueError(f"the sieve tables do not fit the {placement} "
                         f"placement ({smem_bytes(placement, tabs)} bytes "
                         f"of shared memory, at most {SMEM_LIMIT})")
    if data.data_ptr() % 16:
        data = data.clone()             # the kernel loads 16-byte vectors
    dev = data.device
    match = torch.empty(npad, dtype=torch.int32, device=dev)
    bits = torch.empty(npad // 32, dtype=torch.int32, device=dev)
    # one word past the counts: the persistent grid's tile counter
    counts = torch.zeros(npad // block + 1, dtype=torch.int32, device=dev)
    lib = _build.load()
    rc = lib.pfac_sieve(
        dev.index or 0, data.data_ptr(), n, npad, tabs.arena.data_ptr(),
        tabs.arena.numel(), residual_offset(tabs), tabs.desc.data_ptr(),
        PLACEMENTS.index(placement), match.data_ptr(), bits.data_ptr(),
        counts.data_ptr(), block, torch.cuda.current_stream(dev).cuda_stream)
    kernel = f"sieve_{placement}_kernel"
    trace.count(f"launch.{kernel}")
    _build.check(rc, kernel)
    return match, bits, counts[:-1]


def pack_bits(flags: torch.Tensor) -> torch.Tensor:
    """uint8/bool flags[npad] (npad % 32 == 0) -> int32 bitmap words, flag
    32w + j in bit j of word w."""
    shifts = torch.arange(8, dtype=torch.uint8, device=flags.device)
    b8 = (flags.view(-1, 8).to(torch.uint8) << shifts).sum(
        1, dtype=torch.uint8)
    return b8.view(torch.int32)


def unpack_bits(bits: torch.Tensor) -> torch.Tensor:
    """int32 bitmap words -> uint8 flags, one per position."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return ((bits.view(torch.uint8)[:, None] >> shifts) & 1).reshape(-1)


def sieve_plain(data: torch.Tensor, n: int, npad: int, tabs: Packed,
                block: int = BLOCK):
    """Plain torch version of K1, on the data's device."""
    dev = data.device
    ext = torch.zeros(npad + 3, dtype=torch.uint8, device=dev)
    ext[:n] = data[:n]                  # bytes at and past n read as 0
    a = unsigned(tabs.arena)
    m2, m3, al = tabs.rows
    match = torch.empty(npad, dtype=torch.int32, device=dev)
    bits = torch.empty(npad // 32, dtype=torch.int32, device=dev)
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
            s = slot(a, al, k4)
            r16 = (a[al[5] + (s >> 1)] >> (16 * (s & 1))) & 0xFFFF
            f = (r16 == (mul32(k4, MIX_RESID) >> 16)) & (rd > 3)
        bits[c0 // 32:c1 // 32] = pack_bits(f)
    counts = unpack_bits(bits).view(-1, block).sum(1, dtype=torch.int32)
    return match, bits, counts


def gated_m1(tabs: Packed) -> torch.Tensor:
    """int64[256]: the m1 words as K1 stages them: byte c's length-1 ID,
    with GATE2 set where some m2 key starts with c and GATE3 where some m3
    key does. The keys are read from every slot (an empty slot holds a
    member key)."""
    a = unsigned(tabs.arena)
    m1 = a[:256].clone()
    for row, gate in zip(tabs.rows[:2], (GATE2, GATE3)):
        if row[6]:
            first = a[row[4]:row[4] + (1 << row[2])] & 0xFF
            m1[first] |= gate
    return m1


def short_probes_plain(data: torch.Tensor, n: int, tabs: Packed) -> int:
    """The m2 and m3 key probes K1 issues on the first n bytes of `data`:
    position pos probes m2 where its byte opens GATE2 and n - pos > 1, m3
    where it opens GATE3 and n - pos > 2."""
    g = gated_m1(tabs).to(data.device)[data[:n].long()]
    return (int(((g & GATE2) != 0)[:max(n - 1, 0)].sum())
            + int(((g & GATE3) != 0)[:max(n - 2, 0)].sum()))

"""Survivor compaction: the kernels of ``csrc/compact.cu`` and their plain
torch version.

They replace the reference's bitmap compaction
``pfac_tpu.backends.pallas_sieve._compact`` and its MXU prefix sums. From
K1's survivor bitmap and per-block counts they list the survivor positions
in ascending order, as int32, leaving out every block whose count reaches
the dense threshold (``block // DENSE_ESCAPE_DIV`` when the escape is
armed): the escape (K3) walks those blocks whole. ``compact_scan_kernel``
scans the counts into block offsets and the total; ``compact_kernel``
expands each block's bits. The total stays on the device: the positions go
into a buffer whose size needs no count (:func:`capacity`), and the walkers
read the total there, so the host never waits for it.
"""
from __future__ import annotations

import torch

from .. import _build
from .sieve import unpack_bits

#: launches of each compaction kernel since the counts were last reset
#: (only where the kernels run)
LAUNCHES = {"compact_scan_kernel": 0, "compact_kernel": 0}


def _check(bits: torch.Tensor, counts: torch.Tensor) -> int:
    for name, t in (("bits", bits), ("counts", counts)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
    if bits.device != counts.device:
        raise ValueError("bits and counts must be on one device")
    npad = 32 * bits.shape[0]
    if counts.shape[0] == 0 or npad % counts.shape[0]:
        raise ValueError("need a count for each of the bitmap's blocks")
    block = npad // counts.shape[0]
    if block % 8192:
        raise ValueError("the block must be a multiple of 8192 positions")
    return block


def capacity(nblocks: int, block: int, thresh: int) -> int:
    """Room for the positions compact() lists: a block it does not leave
    out has fewer than `thresh` survivors, and never more than `block`
    (with the escape armed at 128 MB: 2,048 blocks x 16,383, 134 MB of
    int32; disarmed, as on the CSR tier, npad positions)."""
    return nblocks * max(0, min(thresh - 1, block))


def compact(bits: torch.Tensor, counts: torch.Tensor, thresh: int, *,
            out: torch.Tensor | None = None,
            values: torch.Tensor | None = None,
            ids: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (pos, count): the positions of the set bits of `bits` (bit j of
    word w: position 32w + j), ascending, int32, without the blocks whose
    count is at least `thresh`, in pos[:count]; count is a 1-element int32
    tensor on the bits' device. `counts[b]` must be block b's number of set
    bits. A CPU tensor runs the plain version (pos is exact); a CUDA tensor
    launches the kernels into a buffer of :func:`capacity` positions, whose
    words past the count are undefined, and reads nothing back.

    `out` (int32, room for every position listed) takes the positions
    instead of a new buffer, and is returned as pos. With `values` (int32,
    indexed by position) and `ids` (room for every position listed),
    ids[i] = values[pos[i]] as well: the device reduce's gather, done by
    compact_kernel as it writes each position."""
    block = _check(bits, counts)
    if (values is None) != (ids is None):
        raise ValueError("values and ids go together")
    dev = bits.device
    if dev.type == "cpu":
        pos = compact_plain(bits, counts, thresh)
        k = pos.shape[0]
        if values is not None:
            ids[:k] = values[pos.long()]
        if out is not None:
            out[:k] = pos
            pos = out
        return pos, torch.tensor([k], dtype=torch.int32)
    if dev.type != "cuda":
        raise ValueError(f"no compaction for device {dev}")
    for t in (out, values, ids):
        if t is not None and (t.dtype != torch.int32 or t.device != dev
                              or not t.is_contiguous()):
            raise ValueError("out, values and ids must be contiguous int32 "
                             "tensors on the bits' device")
    nblocks = counts.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load()
    offsets = torch.empty(nblocks + 1, dtype=torch.int32, device=dev)
    rc = lib.pfac_compact_scan(dev.index or 0, counts.data_ptr(), nblocks,
                               thresh, offsets.data_ptr(), stream)
    LAUNCHES["compact_scan_kernel"] += 1
    _build.check(rc, "compact_scan_kernel")
    pos = out
    if pos is None:
        pos = torch.empty(capacity(nblocks, block, thresh), dtype=torch.int32,
                          device=dev)
    rc = lib.pfac_compact(dev.index or 0, bits.data_ptr(), counts.data_ptr(),
                          offsets.data_ptr(), nblocks, block, thresh,
                          pos.data_ptr(),
                          None if values is None else values.data_ptr(),
                          None if ids is None else ids.data_ptr(), stream)
    LAUNCHES["compact_kernel"] += 1
    _build.check(rc, "compact_kernel")
    return pos, offsets[nblocks:]


def compact_plain(bits: torch.Tensor, counts: torch.Tensor,
                  thresh: int) -> torch.Tensor:
    """Plain torch version: unpack the bits, clear the dense blocks,
    ``torch.nonzero``."""
    flags = unpack_bits(bits).view(counts.shape[0], -1)
    flags[counts >= thresh] = 0
    return torch.nonzero(flags.view(-1)).reshape(-1).to(torch.int32)

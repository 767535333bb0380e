"""Survivor compaction: the kernels of ``csrc/compact.cu`` and their plain
torch version.

They replace the reference's bitmap compaction
``pfac_tpu.backends.pallas_sieve._compact`` and its MXU prefix sums. From
K1's survivor bitmap and per-block counts they list the survivor positions
in ascending order, as int32, leaving out every block whose count reaches
the dense threshold (``block // DENSE_ESCAPE_DIV`` when the escape is
armed): the escape (K3) walks those blocks whole. ``compact_scan_kernel``
scans the counts into block offsets and the total; the wrapper copies the
total to the host (4 bytes, the pipeline's one host round trip) to size
the positions; ``compact_kernel`` expands each block's bits.
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


def compact(bits: torch.Tensor, counts: torch.Tensor,
            thresh: int) -> torch.Tensor:
    """Positions of the set bits of `bits` (bit j of word w: position
    32w + j), ascending, int32, without the blocks whose count is at least
    `thresh`. `counts[b]` must be block b's number of set bits. A CPU tensor
    runs the plain version; a CUDA tensor launches the kernels."""
    block = _check(bits, counts)
    dev = bits.device
    if dev.type == "cpu":
        return compact_plain(bits, counts, thresh)
    if dev.type != "cuda":
        raise ValueError(f"no compaction for device {dev}")
    nblocks = counts.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load()
    offsets = torch.empty(nblocks + 1, dtype=torch.int32, device=dev)
    rc = lib.pfac_compact_scan(dev.index or 0, counts.data_ptr(), nblocks,
                               thresh, offsets.data_ptr(), stream)
    LAUNCHES["compact_scan_kernel"] += 1
    _build.check(rc, "compact_scan_kernel")
    pos = torch.empty(int(offsets[nblocks]), dtype=torch.int32, device=dev)
    rc = lib.pfac_compact(dev.index or 0, bits.data_ptr(), counts.data_ptr(),
                          offsets.data_ptr(), nblocks, block, thresh,
                          pos.data_ptr(), stream)
    LAUNCHES["compact_kernel"] += 1
    _build.check(rc, "compact_kernel")
    return pos


def compact_plain(bits: torch.Tensor, counts: torch.Tensor,
                  thresh: int) -> torch.Tensor:
    """Plain torch version: unpack the bits, clear the dense blocks,
    ``torch.nonzero``."""
    flags = unpack_bits(bits).view(counts.shape[0], -1)
    flags[counts >= thresh] = 0
    return torch.nonzero(flags.view(-1)).reshape(-1).to(torch.int32)

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

from .. import _build, trace
from .sieve import unpack_bits

#: the compaction's kernels (counted as ``launch.<kernel>`` in ``trace``,
#: only where the kernels run)
KERNELS = ("compact_scan_kernel", "compact_kernel")

#: ``compact_kernel`` lists a warp's round (its run of bitmap words, up to
#: 8 chunks of 32 words) lane by lane where the round holds at most
#: ROUND_MAX set bits, a denser round word by word (``kRoundMax`` in
#: ``csrc/compact.cu``)
ROUND_MAX = 509


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


def compact(bits: torch.Tensor, counts: torch.Tensor, thresh: int,
            counters: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (pos, count): the positions of the set bits of `bits` (bit j of
    word w: position 32w + j), ascending, int32, without the blocks whose
    count is at least `thresh`, in pos[:count]; count is a 1-element int32
    tensor on the bits' device. `counts[b]` must be block b's number of set
    bits. A CPU tensor runs the plain version (pos is exact); a CUDA tensor
    launches the kernels into a buffer of :func:`capacity` positions, whose
    words past the count are undefined, and reads nothing back; given
    `counters` (int64[1] on that device), ``compact_kernel`` adds to it the
    chunks it listed word by word (:func:`wordwise_chunks_plain`)."""
    block = _check(bits, counts)
    dev = bits.device
    if dev.type == "cpu":
        pos = compact_plain(bits, counts, thresh)
        return pos, torch.tensor([pos.shape[0]], dtype=torch.int32)
    if dev.type != "cuda":
        raise ValueError(f"no compaction for device {dev}")
    if bits.data_ptr() % 16:           # the kernel loads 16 B a lane
        bits = bits.clone()
    nblocks = counts.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load()
    offsets = torch.empty(nblocks + 1, dtype=torch.int32, device=dev)
    rc = lib.pfac_compact_scan(dev.index or 0, counts.data_ptr(), nblocks,
                               thresh, offsets.data_ptr(), None, stream)
    trace.count("launch.compact_scan_kernel")
    _build.check(rc, "compact_scan_kernel")
    pos = torch.empty(capacity(nblocks, block, thresh), dtype=torch.int32,
                      device=dev)
    rc = lib.pfac_compact(dev.index or 0, bits.data_ptr(), counts.data_ptr(),
                          offsets.data_ptr(), nblocks, block, thresh,
                          pos.data_ptr(),
                          None if counters is None else counters.data_ptr(),
                          stream)
    trace.count("launch.compact_kernel")
    _build.check(rc, "compact_kernel")
    return pos, offsets[nblocks:]


def compact_plain(bits: torch.Tensor, counts: torch.Tensor,
                  thresh: int) -> torch.Tensor:
    """Plain torch version: unpack the bits, clear the dense blocks,
    ``torch.nonzero``."""
    flags = unpack_bits(bits).view(counts.shape[0], -1)
    flags[counts >= thresh] = 0
    return torch.nonzero(flags.view(-1)).reshape(-1).to(torch.int32)


def wordwise_chunks_plain(bits: torch.Tensor, counts: torch.Tensor,
                          thresh: int) -> int:
    """The 32-word chunks of the bitmap that ``compact_kernel`` lists word
    by word (the device counter ``compact_wordwise_chunks`` of one program
    call): in the blocks it lists (0 < count < `thresh`), a warp takes a run
    of block / 256 words in rounds of up to 8 chunks; the nonempty chunks of
    a round of more than :data:`ROUND_MAX` set bits."""
    block = _check(bits, counts)
    chunks = block // 8192                      # a warp's run
    sums = unpack_bits(bits).view(counts.shape[0], 8, chunks, 1024).sum(
        3, dtype=torch.int32)
    rounds = torch.arange(chunks, device=bits.device) // 8
    totals = torch.zeros(*sums.shape[:2], -(-chunks // 8),
                         dtype=torch.int32, device=bits.device).index_add_(
                             2, rounds, sums)[:, :, rounds]
    listed = ((counts > 0) & (counts < thresh))[:, None, None]
    return int(((sums > 0) & (totals > ROUND_MAX) & listed).sum())

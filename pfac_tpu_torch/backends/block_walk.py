"""Dense-block escape: kernel K3 and its plain torch version.

K3 (``block_walk_kernel`` in ``csrc/walk.cu``) replaces the Pallas
block-walk kernel ``pfac_tpu.backends.pallas_sieve.build_block_walk``. A
block of ``block`` positions is dense when the sieve counted at least
``block // DENSE_ESCAPE_DIV`` survivors in it (``DENSE_ESCAPE_DIV = 4``, as
the reference's ``pallas_sieve.DENSE_ESCAPE_DIV``). Every position of a
dense block is walked to full depth with K2's walk and its matches of >= 4
bytes written into the sieve's result in place. The compaction
(``compact.py``) reads the same counts and threshold and leaves the block
out, so K2 never sees its positions. The sieve already wrote the exact
depth-1..3 match at every position, so the block's result is then
complete, as the reference's K3 writes it.

The kernel reads the counts on the device and returns at once for a block
that is not dense: the escape needs no host round trip, and a corpus
without dense blocks pays one near-empty launch. The reference batches 64
blocks per launch to save XLA dispatch; one launch covers every block here.
"""
from __future__ import annotations

import torch

from .. import _build
from .probe import Packed
from .walk import walk_plain

#: K3 launches since the count was last reset (only where the kernel runs)
LAUNCHES = 0

DENSE_ESCAPE_DIV = 4        # as pfac_tpu.backends.pallas_sieve
_PLAIN_CHUNK = 1 << 22      # positions per walk_plain call


def _check(data, n, counts, match, tabs: Packed) -> int:
    if data.dtype != torch.uint8 or data.dim() != 1 or not data.is_contiguous():
        raise ValueError("data must be a contiguous 1-D uint8 tensor")
    npad = match.shape[0]
    if (counts.dtype != torch.int32 or match.dtype != torch.int32
            or counts.shape[0] == 0 or npad % counts.shape[0]
            or not (match.is_contiguous() and counts.is_contiguous())):
        raise ValueError("need int32 counts[nblocks] and int32 match[npad], "
                         "contiguous, nblocks | npad")
    if not 0 <= n <= min(data.shape[0], npad):
        raise ValueError("need n <= len(data) and n <= npad")
    for t in (counts, match, tabs.arena, tabs.desc):
        if t.device != data.device:
            raise ValueError("all tensors must be on the data's device")
    return npad // counts.shape[0]


def block_walk(data: torch.Tensor, n: int, counts: torch.Tensor,
               match: torch.Tensor, tabs: Packed) -> None:
    """Walk every position of each dense block into `match` in place. A CPU
    tensor runs the plain version; a CUDA tensor launches K3."""
    block = _check(data, n, counts, match, tabs)
    if data.device.type == "cpu":
        return block_walk_plain(data, n, counts, match, tabs)
    if data.device.type != "cuda":
        raise ValueError(f"no block walk for device {data.device}")
    if block % 8192:
        raise ValueError("the block must be a multiple of 8192 positions")
    global LAUNCHES
    nsteps = (len(tabs.rows) - 2) // 3
    lib = _build.load()
    rc = lib.pfac_block_walk(
        data.device.index or 0, data.data_ptr(), n, counts.data_ptr(),
        counts.shape[0], block, block // DENSE_ESCAPE_DIV,
        tabs.arena.data_ptr(), tabs.desc.data_ptr(), nsteps,
        match.data_ptr(), torch.cuda.current_stream(data.device).cuda_stream)
    LAUNCHES += 1
    _build.check(rc, "block_walk_kernel")
    return None


def block_walk_plain(data: torch.Tensor, n: int, counts: torch.Tensor,
                     match: torch.Tensor, tabs: Packed) -> None:
    """Plain torch version of K3, on the data's device."""
    block = match.shape[0] // counts.shape[0]
    dense = torch.nonzero(counts >= block // DENSE_ESCAPE_DIV).reshape(-1)
    if dense.numel() == 0:
        return None
    pos = (dense[:, None] * block
           + torch.arange(block, device=data.device)).reshape(-1)
    pos = pos[pos < n].to(torch.int32)
    for c0 in range(0, pos.shape[0], _PLAIN_CHUNK):
        walk_plain(data, n, pos[c0:c0 + _PLAIN_CHUNK], match, tabs)
    return None


def escaped_blocks(counts: torch.Tensor, npad: int) -> int:
    """How many blocks the escape walks for these sieve counts."""
    block = npad // counts.shape[0]
    return int((counts >= block // DENSE_ESCAPE_DIV).sum())

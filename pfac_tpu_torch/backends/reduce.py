"""Device reduce: a dense result to ``(ids, positions, count)`` on the
device, for both engines' ``match_reduce_device``.

Counterpart of ``pfac_tpu.backends.pallas_sieve.reduce_from_dense`` and the
function behind it, ``pfac_tpu.backends.xla._reduce_rowgather``, with its
contract: ``ids`` and ``positions`` are int32 arrays as long as the result,
positions ascending, every entry past the count zero; the count is a 0-d
int32 tensor on the device.

On a CUDA tensor the host never waits for the device. Three launches:
``reduce_flags_kernel`` (``csrc/compact.cu``) writes the bitmap of
``result > 0`` and each 64K block's count; the compaction's
``compact_scan_kernel`` and ``compact_kernel`` (``compact.py``) then list
the positions with ``thresh = block + 1``, so that no block is left out,
and ``compact_kernel`` gathers each position's ID as it writes it, into
outputs zeroed beforehand. The count stays in the scan's offsets. The
bitmap is padded with zero words to whole blocks, so any length works.

The plain version (:func:`reduce_plain`: ``torch.nonzero`` and two indexed
copies) serves CPU tensors and is the reference the card run checks.
"""
from __future__ import annotations

import torch

from .. import _build
from . import compact
from .sieve import BLOCK, pack_bits

#: reduce_flags_kernel launches since the count was last reset (only where
#: the kernel runs)
LAUNCHES = {"reduce_flags_kernel": 0}


def _check(result: torch.Tensor) -> int:
    if (result.dtype != torch.int32 or result.dim() != 1
            or not result.is_contiguous()):
        raise ValueError("the result must be a contiguous 1-D int32 tensor")
    npad = result.shape[0]
    if npad >= 1 << 31:
        raise ValueError("positions must fit int32")
    return npad


def reduce_flags(result: torch.Tensor,
                 block: int = BLOCK) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (bits, counts): the bitmap of ``result > 0`` (int32 words, padded
    with zeros to whole blocks) and each block's count of set bits. A CPU
    tensor runs :func:`reduce_flags_plain`; a CUDA tensor launches
    reduce_flags_kernel."""
    npad = _check(result)
    dev = result.device
    if dev.type == "cpu":
        return reduce_flags_plain(result, block)
    if dev.type != "cuda":
        raise ValueError(f"no reduce for device {dev}")
    nblocks = -(-npad // block)
    bits = torch.empty(nblocks * block // 32, dtype=torch.int32, device=dev)
    counts = torch.empty(nblocks, dtype=torch.int32, device=dev)
    rc = _build.load().pfac_reduce_flags(
        dev.index or 0, result.data_ptr(), npad, block, nblocks,
        bits.data_ptr(), counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["reduce_flags_kernel"] += 1
    _build.check(rc, "reduce_flags_kernel")
    return bits, counts


def reduce_flags_plain(result: torch.Tensor,
                       block: int = BLOCK) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of reduce_flags_kernel, on the result's device."""
    npad = _check(result)
    nblocks = -(-npad // block)
    flags = torch.zeros(nblocks * block, dtype=torch.uint8,
                        device=result.device)
    flags[:npad] = result > 0
    counts = flags.view(nblocks, block).sum(1, dtype=torch.int32)
    return pack_bits(flags), counts


def reduce_from_dense(result: torch.Tensor):
    """int32[npad] -> (ids, positions, count): npad-long int32 arrays,
    positions ascending, zeros past count; count a 0-d int32 tensor on the
    result's device. A CPU tensor runs :func:`reduce_plain`; a CUDA tensor
    launches the kernels and reads nothing back."""
    npad = _check(result)
    dev = result.device
    if dev.type == "cpu" or npad == 0:
        return reduce_plain(result)
    if dev.type != "cuda":
        raise ValueError(f"no reduce for device {dev}")
    bits, counts = reduce_flags(result)
    ids = torch.zeros(npad, dtype=torch.int32, device=dev)
    pos = torch.zeros(npad, dtype=torch.int32, device=dev)
    _, count = compact.compact(bits, counts, BLOCK + 1, out=pos,
                               values=result, ids=ids)
    return ids, pos, count[0]


def reduce_plain(result: torch.Tensor):
    """Plain torch version of :func:`reduce_from_dense`."""
    _check(result)
    pos = torch.nonzero(result > 0).reshape(-1)
    k = pos.shape[0]
    ids = torch.zeros_like(result)
    out = torch.zeros_like(result)
    ids[:k] = result[pos]
    out[:k] = pos.to(torch.int32)
    return ids, out, torch.tensor(k, dtype=torch.int32, device=result.device)

"""Match count: the number of nonzero words of a result, ``count_kernel``
(``csrc/count.cu``) and its plain torch version.

Counterpart of the sharded call's count in ``pfac_tpu.dist.sharding``
(``count_fn``: ``jnp.sum(matches > 0)``, an XLA program of its own). The
kernel reads the int32 result once, reduces in the warp and in the CTA and
adds into one int64 word with one atomic a CTA: no flag tensor is written.
Its bound is 4 B a position. The sharded program (``program.py``) runs the
same kernel as its last node, over every shard a device holds; this
wrapper counts one tensor.
"""
from __future__ import annotations

import torch

from .. import _build, trace

def bound_bytes(words: int) -> int:
    """Bytes the count must move: the result read once (4 B a position);
    the one output word is not counted."""
    return 4 * words


def count_nonzero(result: torch.Tensor) -> torch.Tensor:
    """int32[n] -> its number of nonzero words, a 0-d int64 tensor on the
    result's device. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel and reads nothing back."""
    if (result.dtype != torch.int32 or result.dim() != 1
            or not result.is_contiguous()):
        raise ValueError("the result must be a contiguous 1-D int32 tensor")
    dev = result.device
    if dev.type == "cpu":
        return count_nonzero_plain(result)
    if dev.type != "cuda":
        raise ValueError(f"no count for device {dev}")
    n = result.shape[0]
    out = torch.empty((), dtype=torch.int64, device=dev)
    rc = _build.load().pfac_count(
        dev.index or 0, result.data_ptr(), n, max(n, 1), 1, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    trace.count("launch.count_kernel")
    _build.check(rc, "count_kernel")
    return out


def count_nonzero_plain(result: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`count_nonzero`."""
    return (result != 0).sum()

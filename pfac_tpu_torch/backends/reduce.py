"""Device reduce: a dense result to ``(ids, positions, count)`` on the
device, for both engines' ``match_reduce_device``.

Counterpart of ``pfac_tpu.backends.pallas_sieve.reduce_from_dense`` and the
function behind it, ``pfac_tpu.backends.xla._reduce_rowgather``, with its
contract: ``ids`` and ``positions`` are int32 arrays as long as the result,
positions ascending, every entry past the count zero; the count is a 0-d
int32 tensor on the device.

On a CUDA tensor the host never waits for the device. Two launches
(``csrc/reduce.cu``): ``reduce_kernel`` reads the result once in tiles of
:data:`TILE` positions, finds each tile's offset by decoupled look-back
and writes slots ``[0, count)`` of both outputs, the IDs from the values
it loaded; ``reduce_tail_kernel`` reads the count on the device and writes
the zeros of slots ``[count, npad)``. Each output word is written once, so
nothing is zeroed beforehand. The look-back's status words live in a
scratch buffer kept per device and stream; each call marks its words with
a new epoch, so the buffer is never reset.

The plain version (:func:`reduce_plain`: ``torch.nonzero`` and two indexed
copies) serves CPU tensors and is the reference the card run checks;
:func:`reduce_tiles_plain` repeats the kernels' own arithmetic (tile
counts, look-back offsets, the zeros past the count) for the tests.
"""
from __future__ import annotations

import torch

from .. import _build, trace

#: the reduce's kernels (counted as ``launch.<kernel>`` in ``trace``, only
#: where the kernels run)
KERNELS = ("reduce_kernel", "reduce_tail_kernel")
TILE = 8192        # positions a CTA of reduce_kernel takes (csrc/reduce.cu)
_EPOCHS = 1 << 32  # the status words' epoch is 32 bits, 0 never used

#: (device, stream) -> [status words, the last epoch used]
_SCRATCH: dict[tuple[int, int], list] = {}


def _check(result: torch.Tensor) -> int:
    if (result.dtype != torch.int32 or result.dim() != 1
            or not result.is_contiguous()):
        raise ValueError("the result must be a contiguous 1-D int32 tensor")
    npad = result.shape[0]
    if npad >= 1 << 31:
        raise ValueError("positions must fit int32")
    return npad


def bound_bytes(npad: int) -> int:
    """Bytes the reduce must move: the result read once (4 B a position)
    and both outputs written in full (4 + 4 B a position), whatever the
    count."""
    return 12 * npad


def tiles(npad: int) -> int:
    return -(-npad // TILE)


def _scratch(dev: torch.device, stream: int,
             need: int) -> tuple[torch.Tensor, int]:
    """-> (status words, epoch) for one call on `stream`: the ticket, then
    a word a tile, none of them of the epoch returned. Zeroed when made or
    grown and when the epochs wrap."""
    key = (dev.index or 0, stream)
    entry = _SCRATCH.get(key)
    if entry is None or entry[0].numel() < need:
        size = max(need, 2 * (0 if entry is None else entry[0].numel()))
        entry = _SCRATCH[key] = [
            torch.zeros(size, dtype=torch.int64, device=dev), 0]
    entry[1] += 1
    if entry[1] == _EPOCHS:
        entry[0].zero_()
        entry[1] = 1
    return entry[0], entry[1]


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
    ids = torch.empty(npad, dtype=torch.int32, device=dev)
    pos = torch.empty(npad, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status, epoch = _scratch(dev, stream, tiles(npad) + 1)
    rc = _build.load().pfac_reduce(
        dev.index or 0, result.data_ptr(), npad, ids.data_ptr(),
        pos.data_ptr(), count.data_ptr(), status.data_ptr(), status.numel(),
        epoch, stream)
    trace.count("launch.reduce_kernel")
    trace.count("launch.reduce_tail_kernel")
    _build.check(rc, "reduce_kernel")
    return ids, pos, count


def tile_counts_plain(result: torch.Tensor) -> torch.Tensor:
    """Each tile's count of positions with result > 0 (what a tile of
    reduce_kernel publishes as its aggregate), int32[tiles]."""
    npad = _check(result)
    flags = torch.zeros(tiles(npad) * TILE, dtype=torch.int32,
                        device=result.device)
    flags[:npad] = result > 0
    return flags.view(-1, TILE).sum(1, dtype=torch.int32)


def tile_offsets_plain(counts: torch.Tensor) -> torch.Tensor:
    """The exclusive prefix sums of the tile counts: the offset each tile's
    look-back must find, int32[tiles]."""
    return (torch.cumsum(counts, 0, dtype=torch.int64) - counts).to(
        torch.int32)


def reduce_tiles_plain(result: torch.Tensor):
    """Plain torch version of the two kernels, step by step: each tile's
    matches at its offset plus their rank in the tile (ascending
    positions), the IDs from the result, the count from the last tile's
    inclusive prefix, then zeros over [count, npad). -> (ids, positions,
    count) as :func:`reduce_from_dense`."""
    npad = _check(result)
    counts = tile_counts_plain(result)
    offsets = tile_offsets_plain(counts)
    count = int(offsets[-1] + counts[-1]) if npad else 0
    flags = result > 0
    at = torch.nonzero(flags).reshape(-1)
    tile = at // TILE
    first = torch.searchsorted(at, tile * TILE)      # the tile's first match
    slot = offsets[tile].long() + (torch.arange(at.numel(),
                                                device=at.device) - first)
    ids = torch.empty_like(result)
    pos = torch.empty_like(result)
    ids[slot] = result[at]
    pos[slot] = at.to(torch.int32)
    ids[count:] = 0
    pos[count:] = 0
    return ids, pos, torch.tensor(count, dtype=torch.int32)


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

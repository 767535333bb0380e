"""Table-probe kernels G1-G4 (``csrc/gather_micro.cu``) and their plain
torch versions.

They replace the Pallas kernels of the reference's gather
micro-benchmarks (``experiments/*.py``, E1-E6). Each of those tried a TPU
layout that makes a dynamic gather lowerable and fast; on the card every
layout is the same indexed load, so four kernels serve all nine sites:

* G1 :func:`word_gather`: ``out[i] = table[idx[i]]``, the table read from
  shared memory (``"smem"``, at most :data:`SMEM_WORDS` words), through L1
  (``"ldg"``) or from L2 only (``"cg"``);
* G2 :func:`tile_gather`: ``take_along_axis`` on an int32 tile, along
  axis 1 (``out[i, j] = tile[i % R, idx[i, j]]``) or axis 0
  (``out[i, j] = tile[idx[i, j], j]``);
* G3 :func:`chain_gather`: ``chain`` dependent loads per index;
* G4 :func:`align`: the walker's window align, one thread per survivor.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel, or
raises. Indices must lie in range: as for the walks' positions, nothing
checks them on the device.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import _build
from ..backends.probe import U32, mul32

#: launches of each kernel since the counts were last reset (only where the
#: kernel runs)
LAUNCHES = {"word_gather_kernel": 0, "tile_gather_kernel": 0,
            "chain_gather_kernel": 0, "align_kernel": 0}
PLACEMENTS = ("smem", "ldg", "cg")
SMEM_WORDS = 232_448 // 4     # the most dynamic shared memory a CTA may use
CHAIN_MUL = 0x9E3779B1        # G3's hashed step
STRIP = 32                    # G2, axis 0: tile columns staged per CTA
ALIGN_SPAN = 32               # G4: window offsets 0..31
GROUP = 8 * 128               # G4: survivors per (8, 128) group


def _int32(**tensors: torch.Tensor) -> torch.device:
    """Check contiguous int32 tensors on one device; -> the device."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError("all tensors must be on one device")
    for name, t in tensors.items():
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor")
    return devs.pop()


def _fits(placement: str, words: int) -> None:
    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}")
    if placement == "smem" and words > SMEM_WORDS:
        raise ValueError(f"a {words}-word table does not fit in shared memory "
                         f"(at most {SMEM_WORDS} words)")


def _launch(kernel: str, entry: str, dev: torch.device, *args) -> None:
    if dev.type != "cuda":
        raise ValueError(f"no {kernel} for device {dev}")
    lib = _build.load()
    rc = getattr(lib, entry)(dev.index or 0, *args,
                             torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES[kernel] += 1
    _build.check(rc, kernel)


def word_gather(table: torch.Tensor, idx: torch.Tensor,
                placement: str = "ldg") -> torch.Tensor:
    """G1: ``table[idx]``, shaped like idx; each idx in [0, table.numel())."""
    dev = _int32(table=table, idx=idx)
    _fits(placement, table.numel())
    if dev.type == "cpu":
        return word_gather_plain(table, idx)
    out = torch.empty_like(idx)
    if idx.numel():
        _launch("word_gather_kernel", "pfac_word_gather", dev,
                table.data_ptr(), table.numel(), idx.data_ptr(), idx.numel(),
                PLACEMENTS.index(placement), out.data_ptr())
    return out


def word_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain torch version of G1."""
    return table[idx.long()]


def _tile_check(tile: torch.Tensor, idx: torch.Tensor, axis: int) -> None:
    if tile.dim() != 2 or idx.dim() != 2 or axis not in (0, 1):
        raise ValueError("need a 2-D tile, 2-D indices and axis 0 or 1")
    rows, cols = tile.shape
    if axis == 0 and idx.shape[1] != cols:
        raise ValueError("axis 0 needs as many index columns as the tile has")
    if axis == 1 and idx.shape[0] % rows:
        raise ValueError("axis 1 needs a multiple of the tile's rows")
    staged = rows * (STRIP if axis == 0 else cols)
    if staged > SMEM_WORDS:
        raise ValueError(f"{staged} staged words do not fit in shared memory "
                         f"(at most {SMEM_WORDS})")


def tile_gather(tile: torch.Tensor, idx: torch.Tensor,
                axis: int) -> torch.Tensor:
    """G2: ``take_along_axis(tile, idx, axis)``, the tile's rows repeated
    down the indices along axis 1 (``out[i, j] = tile[i % R, idx[i, j]]``).
    The staged part (the whole tile, or R x 32 words along axis 0) must fit
    in shared memory."""
    dev = _int32(tile=tile, idx=idx)
    _tile_check(tile, idx, axis)
    if dev.type == "cpu":
        return tile_gather_plain(tile, idx, axis)
    out = torch.empty_like(idx)
    if idx.numel():
        _launch("tile_gather_kernel", "pfac_tile_gather", dev,
                tile.data_ptr(), tile.shape[0], tile.shape[1], idx.data_ptr(),
                idx.shape[0], idx.shape[1], axis, out.data_ptr())
    return out


def tile_gather_plain(tile: torch.Tensor, idx: torch.Tensor,
                      axis: int) -> torch.Tensor:
    """Plain torch version of G2."""
    if axis == 0:
        return torch.gather(tile, 0, idx.long())
    rows, cols = tile.shape
    reps = idx.shape[0] // rows
    return torch.gather(tile.expand(reps, rows, cols), 2,
                        idx.long().view(reps, rows, -1)).view(idx.shape)


def chain_gather(table: torch.Tensor, idx: torch.Tensor, chain: int,
                 placement: str = "ldg", hashed: bool = False) -> torch.Tensor:
    """G3: ``chain`` dependent lookups per index, shaped like idx. Each step
    is ``v = table[v]`` (every word an index), or, hashed, a multiply-shift
    hash of the word and v reduced to [0, W), as a walk hashes its state
    into its next probe (for tables whose words are not indices)."""
    dev = _int32(table=table, idx=idx)
    _fits(placement, table.numel())
    if chain < 1:
        raise ValueError("chain must be >= 1")
    if dev.type == "cpu":
        return chain_gather_plain(table, idx, chain, hashed)
    out = torch.empty_like(idx)
    if idx.numel():
        _launch("chain_gather_kernel", "pfac_chain_gather", dev,
                table.data_ptr(), table.numel(), idx.data_ptr(), idx.numel(),
                chain, PLACEMENTS.index(placement), int(hashed),
                out.data_ptr())
    return out


def chain_gather_plain(table: torch.Tensor, idx: torch.Tensor, chain: int,
                       hashed: bool = False) -> torch.Tensor:
    """Plain torch version of G3 (int64 holding uint32 values)."""
    words = table.numel()
    t = table.to(torch.int64) & U32
    v = idx.to(torch.int64)
    for _ in range(chain):
        x = t[v]
        v = (mul32(x ^ v, CHAIN_MUL) * words) >> 32 if hashed else x
    return v.to(torch.int32)


def _align_check(pos: torch.Tensor, raw: torch.Tensor, w_out: int) -> int:
    if pos.numel() % GROUP or raw.numel() % max(pos.numel(), 1):
        raise ValueError("need pos of (G*8, 128) and raw of (G*W_RAW*8, 128)")
    w_raw = raw.numel() // max(pos.numel(), 1)
    if w_out < 1 or w_out + ALIGN_SPAN - 1 > w_raw:
        raise ValueError(f"need 1 <= w_out and w_out + {ALIGN_SPAN - 1} <= "
                         f"w_raw (w_out={w_out}, w_raw={w_raw})")
    return w_raw


def align(pos: torch.Tensor, raw: torch.Tensor, w_out: int) -> torch.Tensor:
    """G4: the reference's window align (``experiments/align_micro.py``):
    ``out[g*w_out*8 + w*8 + r, l] = raw[(g*w_raw + w + wv)*8 + r, l]`` with
    ``wv = (pos[g*8 + r, l] & 127) >> 2``; out is (G*w_out*8, 128)."""
    dev = _int32(pos=pos, raw=raw)
    w_raw = _align_check(pos, raw, w_out)
    if dev.type == "cpu":
        return align_plain(pos, raw, w_out)
    groups = pos.numel() // GROUP
    out = torch.empty(groups * w_out * 8, 128, dtype=torch.int32, device=dev)
    if groups:
        _launch("align_kernel", "pfac_align", dev, pos.data_ptr(),
                raw.data_ptr(), groups, w_out, w_raw, out.data_ptr())
    return out


def align_plain(pos: torch.Tensor, raw: torch.Tensor,
                w_out: int) -> torch.Tensor:
    """Plain torch version of G4."""
    groups = pos.numel() // GROUP
    w_raw = raw.numel() // max(pos.numel(), 1)
    wv = (pos.reshape(groups, 1, 8, 128) & 127) >> 2
    rows = torch.arange(w_out, device=pos.device).view(1, w_out, 1, 1) + wv
    return torch.gather(raw.reshape(groups, w_raw, 8, 128), 1,
                        rows).reshape(groups * w_out * 8, 128)


def word_gather_library(table: torch.Tensor,
                        idx: torch.Tensor) -> Callable[[], torch.Tensor]:
    """G1's yardstick: one ``torch.take`` with int64 indices made here,
    outside any timing. The port never calls it."""
    idx64 = idx.long()
    return lambda: torch.take(table, idx64)


def tile_gather_library(tile: torch.Tensor, idx: torch.Tensor,
                        axis: int) -> Callable[[], torch.Tensor]:
    """G2's yardstick: one ``torch.gather`` (along axis 1 over the tile
    expanded to the indices' rows, a view) with int64 indices made here,
    outside any timing. The port never calls it."""
    if axis == 0:
        idx64 = idx.long()
        return lambda: torch.gather(tile, 0, idx64)
    rows, cols = tile.shape
    reps = idx.shape[0] // rows
    idx64 = idx.long().view(reps, rows, -1)
    big = tile.expand(reps, rows, cols)
    return lambda: torch.gather(big, 2, idx64)


def cuda_ms(fn: Callable[[], object], reps: int = 10, warmup: int = 2,
            batch: int = 1) -> float:
    """Median CUDA-event time of fn() in ms, after warm-up: each of `reps`
    samples times `batch` calls back to back and divides by `batch`. With
    batch 1 a sample includes the host's time to launch fn's kernels; a
    batch lets the host launch the next call while the card runs one, so
    it measures the card's time wherever that is the longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return float(np.median(times))

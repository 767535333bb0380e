"""Lockstep walk: ``lockstep_dense_kernel`` and ``lockstep_hash_kernel``
(``csrc/lockstep.cu``) and their plain torch version.

The kernels replace ``pfac_tpu.backends.xla.walk_tiles`` as the JAX
package compiles it behind ``_match_dense_padded`` and
``_match_hash_padded``: one device program a call, walking every start
position over the whole automaton. Here it is one launch a call, one
thread a position, each thread breaking out of its own walk; the kernel
reads the uint8 input and its length ``n`` directly (a byte at or past n
is the sentinel, which traps), so the caller pads nothing. The plain
version is the port's torch walk: ``xla.sentinel_pad`` then
``xla.walk_tiles``. The tables are those of ``xla.XlaMatcher``: dense
``(pair_state, pair_match, table_flat)``, hash ``(pair_state, pair_match,
rp_off, rp_key, val_next, val_ch)``, int32 and on the input's device.
"""
from __future__ import annotations

import torch

from .. import _build

KERNELS = {"dense": "lockstep_dense_kernel", "hash": "lockstep_hash_kernel"}
_TABLES = {"dense": 3, "hash": 6}
_PAIRS = 257 * 257          # the pair tables' words: (c1, c2), 256 the end

#: launches of each kernel since the counts were last reset (only where the
#: kernels run)
LAUNCHES = dict.fromkeys(KERNELS.values(), 0)


def bound_bytes(npad: int, n: int) -> int:
    """Bytes the walk must move: the input read once and 4 B written a
    position (5 B a position where n == npad). The tables' rows are not
    counted: what the data touches of them depends on the walks."""
    return n + 4 * npad


def _check(data_u8, n, out, tables, perf_mode):
    if perf_mode not in KERNELS:
        raise ValueError(f"unknown perf_mode {perf_mode!r}")
    if (data_u8.dtype != torch.uint8 or data_u8.dim() != 1
            or not data_u8.is_contiguous()):
        raise ValueError("the data must be a contiguous 1-D uint8 tensor")
    if not 0 <= n <= data_u8.shape[0]:
        raise ValueError(f"n = {n} outside the data's {data_u8.shape[0]} "
                         "bytes")
    if (out.dtype != torch.int32 or out.dim() != 1
            or not out.is_contiguous()):
        raise ValueError("out must be a contiguous 1-D int32 tensor")
    if len(tables) != _TABLES[perf_mode]:
        raise ValueError(f"{perf_mode} mode takes {_TABLES[perf_mode]} "
                         f"tables, not {len(tables)}")
    for t in (out, *tables):
        if t.device != data_u8.device:
            raise ValueError(f"a tensor on {t.device}, the data on "
                             f"{data_u8.device}")
    for t in tables:
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("the tables must be contiguous 1-D int32 "
                             "tensors")
    if any(t.shape[0] != _PAIRS for t in tables[:2]):
        raise ValueError(f"the pair tables must hold {_PAIRS} words")


def lockstep_walk(data_u8: torch.Tensor, n: int, out: torch.Tensor,
                  tables, *, perf_mode: str, num_final: int,
                  max_len: int) -> torch.Tensor:
    """The longest match starting at each position of `out`'s length over
    ``data_u8[:n]`` -> `out` (int32, every word written, 0 at and past n).
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    of `perf_mode` once, reads nothing back and never synchronises."""
    dev = data_u8.device
    if dev.type == "cpu":
        return lockstep_walk_plain(data_u8, n, out, tables,
                                   perf_mode=perf_mode, num_final=num_final,
                                   max_len=max_len)
    if dev.type != "cuda":
        raise ValueError(f"no lockstep walk for device {dev}")
    _check(data_u8, n, out, tables, perf_mode)
    ptrs = [t.data_ptr() for t in tables[2:]]
    ptrs += [None] * (4 - len(ptrs))
    rc = _build.load().pfac_lockstep(
        dev.index or 0, data_u8.data_ptr(), n, out.shape[0],
        tables[0].data_ptr(), tables[1].data_ptr(), int(perf_mode == "hash"),
        *ptrs, num_final, max_len, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES[KERNELS[perf_mode]] += 1
    _build.check(rc, KERNELS[perf_mode])
    return out


def lockstep_walk_plain(data_u8: torch.Tensor, n: int, out: torch.Tensor,
                        tables, *, perf_mode: str, num_final: int,
                        max_len: int) -> torch.Tensor:
    """Plain torch version of :func:`lockstep_walk`: the input padded with
    the sentinel past n, then ``walk_tiles`` over it as one tile."""
    from . import xla

    _check(data_u8, n, out, tables, perf_mode)
    npad = out.shape[0]
    if npad == 0:
        return out
    if perf_mode == "dense":
        step = xla.dense_step_fn(tables[2])
    else:
        step = xla.hash_step_fn(*tables[2:])
    inp = xla.sentinel_pad(data_u8[:min(n, npad + max(max_len, 2))],
                           npad + max(max_len, 2))
    out.copy_(xla.walk_tiles(step, tables[0], tables[1], inp,
                             num_final=num_final, max_len=max_len, tile=npad,
                             num_tiles=1))
    return out

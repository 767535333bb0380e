"""Lockstep walk: ``lockstep_dense_kernel`` and ``lockstep_hash_kernel``
(``csrc/lockstep.cu``) and their plain torch version.

The kernels replace ``pfac_tpu.backends.xla.walk_tiles`` as the JAX
package compiles it behind ``_match_dense_padded`` and
``_match_hash_padded``: one device program a call, walking every start
position over the whole automaton. Here it is one launch a call: a
persistent grid whose warps each take tiles of 256 positions, the
two-byte stage for every position, then the walks past depth 2 packed
onto busy lanes (a warp's queue in shared memory, or each lane's
positions in lockstep where most of the tile walks on), the longest
carried to the warp's next tile. The kernel reads the uint8 input and its
length ``n`` directly (a byte at or past n is the sentinel, which traps),
so the caller pads nothing. The plain version is the port's torch walk:
``xla.sentinel_pad`` then ``xla.walk_tiles``. The tables are those of
``xla.XlaMatcher``: dense ``(pair_state, pair_match, table_flat)``, hash
``(pair_state, pair_match, rp_off, rp_key, val_next, val_ch)``, int32 and
on the input's device, the pair tables as ``xla.pair_tables`` builds them:
the kernel reads ``pair_match`` at column 256 only (``m1``) and derives the
rest from the pair state.

The pair states have two placements: ``"smem"``, the compacted form of
:func:`pair_form` resident in each CTA's shared memory, taken by a call
given the form (:func:`placement_for`: where it fits
:data:`PAIR_SMEM_BYTES`); ``"global"``, ``pair_state`` read through L1/L2,
by a call given none. :func:`pair_lookup_plain` is the compacted lookup in
torch.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build, trace

KERNELS = {"dense": "lockstep_dense_kernel", "hash": "lockstep_hash_kernel"}
_TABLES = {"dense": 3, "hash": 6}
_PAIRS = 257 * 257          # the pair tables' words: (c1, c2), 256 the end
ROW_WORDS = 8               # occupancy words of a row c1 < 256 (256 is 0)
FORM_HEAD = 2 * 256 * ROW_WORDS   # the form's (bits, rank) words
#: the largest compacted form the "smem" placement takes: beside the
#: kernel's 78,864 bytes of warp tiles, queues and carried walks, two CTAs
#: still fit an H100 SM
PAIR_SMEM_BYTES = 32 << 10


def bound_bytes(npad: int, n: int) -> int:
    """Bytes the walk must move: the input read once and 4 B written a
    position (5 B a position where n == npad). The tables' rows are not
    counted: what the data touches of them depends on the walks."""
    return n + 4 * npad


def _slot(c1, c2):
    """The (bits, rank) pair of row c1's 32-column word c2 // 32 sits at
    pair c1 * 8 + (c2 // 32 ^ c1 % 8): rows that start on the same bank of
    shared memory spread their words over the others."""
    return c1 * ROW_WORDS + ((c2 >> 5) ^ (c1 & (ROW_WORDS - 1)))


def pair_form(pair_state: np.ndarray) -> np.ndarray:
    """The compacted pair states -> int32[FORM_HEAD + nonzero pairs]: for
    each 32-column word of rows c1 < 256, its occupancy bits (bit c2 % 32
    where the state after (c1, c2) is not 0) and the count of nonzero pairs
    before it in row-major order, as pair :func:`_slot` (words 2 * slot and
    2 * slot + 1); then the nonzero states in row-major order. The
    sentinel's row and column hold 0 (it raises otherwise)."""
    ps = np.asarray(pair_state, dtype=np.int32).reshape(257, 257)
    if ps[256].any() or ps[:, 256].any():
        raise ValueError("the pair states' sentinel row and column must be 0")
    live = ps[:256, :256] != 0
    bits = np.packbits(live, axis=1, bitorder="little").view("<u4")  # [256, 8]
    counts = live.reshape(256 * ROW_WORDS, 32).sum(axis=1)
    rank = np.concatenate([[0], np.cumsum(counts)[:-1]])
    c1, k = np.divmod(np.arange(256 * ROW_WORDS), ROW_WORDS)
    head = np.empty((256 * ROW_WORDS, 2), np.int32)
    head[_slot(c1, k << 5)] = np.stack([bits.reshape(-1).view(np.int32),
                                        rank.astype(np.int32)], axis=1)
    return np.concatenate([head.reshape(-1),
                           ps[:256, :256][live]]).astype(np.int32)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def pair_lookup_plain(form: torch.Tensor, pair_match: torch.Tensor,
                      num_final: int, c1: torch.Tensor, c2: torch.Tensor):
    """The kernel's two-byte stage in torch: -> (s2, m2), int32, at each
    (c1, c2) in [0, 256] (256 the sentinel), s2 from the compacted `form`
    and m2 = s2 where it is a match, else m1[c1] = pair_match[c1 * 257 +
    256]."""
    c1, c2 = c1.long(), c2.long()
    edge = (c1 == 256) | (c2 == 256)
    w = torch.where(edge, 0, _slot(c1, c2))
    bits = form[2 * w].long() & 0xFFFFFFFF
    b = c2 & 31
    hit = (((bits >> b) & 1) == 1) & ~edge
    at = FORM_HEAD + form[2 * w + 1].long() + _popcount32(bits & ((1 << b) - 1))
    s2 = torch.where(hit, form[torch.where(hit, at, 0)], 0).to(torch.int32)
    m1 = pair_match[c1 * 257 + 256]
    m2 = torch.where((s2 >= 1) & (s2 <= num_final), s2, m1).to(torch.int32)
    return s2, m2


def placement_for(pairs) -> str:
    """Where the kernel reads the pair states of a compacted form `pairs`
    (:func:`pair_form`'s words, or None): ``"smem"`` where it fits
    PAIR_SMEM_BYTES, else ``"global"``."""
    fits = pairs is not None and 4 * int(pairs.shape[0]) <= PAIR_SMEM_BYTES
    return "smem" if fits else "global"


def _check(data_u8, n, out, tables, perf_mode, pairs=None):
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
    if pairs is not None and (
            pairs.dtype != torch.int32 or pairs.dim() != 1
            or not pairs.is_contiguous() or pairs.device != data_u8.device
            or pairs.shape[0] < FORM_HEAD):
        raise ValueError("the compacted pair form must be a contiguous 1-D "
                         f"int32 tensor of >= {FORM_HEAD} words on the "
                         "data's device")
    if pairs is not None and placement_for(pairs) != "smem":
        raise ValueError(f"the compacted pair form's {4 * pairs.shape[0]} "
                         "bytes exceed the shared memory budget of "
                         f"{PAIR_SMEM_BYTES}")


def lockstep_walk(data_u8: torch.Tensor, n: int, out: torch.Tensor,
                  tables, *, perf_mode: str, num_final: int, max_len: int,
                  pairs: torch.Tensor | None = None) -> torch.Tensor:
    """The longest match starting at each position of `out`'s length over
    ``data_u8[:n]`` -> `out` (int32, every word written, 0 at and past n).
    `pairs`: the compacted pair states (:func:`pair_form`) on the data's
    device, which the kernel keeps in shared memory (a form over
    PAIR_SMEM_BYTES raises), or None, which reads ``pair_state`` through
    L1/L2. A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel of `perf_mode` once, reads nothing back and never
    synchronises."""
    _check(data_u8, n, out, tables, perf_mode, pairs)
    dev = data_u8.device
    if dev.type == "cpu":
        return lockstep_walk_plain(data_u8, n, out, tables,
                                   perf_mode=perf_mode, num_final=num_final,
                                   max_len=max_len)
    if dev.type != "cuda":
        raise ValueError(f"no lockstep walk for device {dev}")
    ptrs = [t.data_ptr() for t in tables[2:]]
    ptrs += [None] * (4 - len(ptrs))
    rc = _build.load().pfac_lockstep(
        dev.index or 0, data_u8.data_ptr(), n, out.shape[0],
        tables[0].data_ptr(), tables[1].data_ptr(),
        None if pairs is None else pairs.data_ptr(),
        0 if pairs is None else pairs.shape[0], int(perf_mode == "hash"),
        *ptrs, num_final, max_len, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    trace.count(f"launch.{KERNELS[perf_mode]}")
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

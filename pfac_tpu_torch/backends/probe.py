"""CHD probe math over flat tables, written once in plain torch.

Counterpart of ``pfac_tpu.backends.pallas_sieve._lookup`` / ``_probe_slot``
and ``pallas_walk._probe``. On the TPU a table is a stack of lane-replicated
(8, 128) planes scanned with lane gathers; here every table is a flat int32
array and a probe is a plain index. ``csrc/probe.cuh`` carries the same math
for the kernels.

A probe hashes a 32-bit key with ONE wrapping multiply, ``prod = key * mul``:

* displacement-free tables: ``slot = prod >> (32 - lg_r)``;
* CHD tables: ``bucket = prod >> (32 - lg_b)``,
  ``h1 = (prod >> (32 - lg_b - lg_r)) & (2^lg_r - 1)``,
  ``slot = (h1 ^ disp[bucket]) & (2^lg_r - 1)``.

Exact tables store the key of every slot; an empty slot holds a *member*
key (``chd.build_exact2`` / ``build_exact_wide2``), so key equality alone
decides a hit. Residual filters store a 16-bit residual per slot instead.

All tables of one kernel live in one int32 arena (the walk tables keep
their values in 16-bit half-words, ``walk_tables.pack_walk``); each probe
is described by one row of ``DESC_WORDS`` int32 words:
``[mul, lg_b, lg_r, disp_off, key_off, val_off, present, 0]``
(offsets are -1 where the array is absent).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

U32 = 0xFFFFFFFF
DESC_WORDS = 8
MIX_RESID = 0xC2B2AE35     # chd.MIX_RESID: the alive filter's residual hash


@dataclasses.dataclass
class FlatProbe:
    """One CHD table as flat arrays (int32 views of the uint32 words)."""
    mul: int                    # odd 32-bit slot multiplier
    lg_b: int                   # log2(buckets); 0 when displacement-free
    lg_r: int                   # log2(slots)
    disp: np.ndarray | None     # int32[2**lg_b] displacements (None: no disp)
    keys: np.ndarray | None     # int32[2**lg_r] key per slot (None: filter)
    vals: np.ndarray            # int32[2**lg_r] value or residual per slot

    @property
    def nodisp(self) -> bool:
        return self.disp is None

    def slot(self, key: int) -> int:
        """Host oracle of the slot hash."""
        prod = (int(key) * self.mul) & U32
        rmask = (1 << self.lg_r) - 1
        if self.nodisp:
            return (prod >> (32 - self.lg_r)) & rmask
        bk = (prod >> (32 - self.lg_b)) & ((1 << self.lg_b) - 1)
        h1 = (prod >> (32 - self.lg_b - self.lg_r)) & rmask
        return (h1 ^ int(self.disp[bk])) & rmask

    def lookup(self, key: int) -> tuple[bool, int]:
        """Host oracle of an exact probe -> (hit, value)."""
        s = self.slot(key)
        hit = (int(self.keys[s]) & U32) == (int(key) & U32)
        return hit, int(self.vals[s]) & U32


def _i32(x: int) -> int:
    """A uint32 bit pattern as the int32 the descriptor array stores."""
    return int(np.uint32(x & U32).view(np.int32))


@dataclasses.dataclass
class Packed:
    """A kernel's tables on one device: the arena, the descriptor rows, and
    the same rows as Python ints (the plain versions branch on them)."""
    arena: torch.Tensor         # int32[words]
    desc: torch.Tensor          # int32[len(rows), DESC_WORDS]
    rows: list[tuple[int, ...]]
    #: what a wrapper derives from the rows once and keeps (launch plans,
    #: the walk tables' ends)
    derived: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)
    #: the walk tables' K2 records, derived from the rows
    #: (``walk_tables.walk_records``); None for other tables
    records: torch.Tensor | None = None


def pack(probes: list[FlatProbe | None], device,
         head: np.ndarray | None = None) -> Packed:
    """Lay `head` (if any) at arena offset 0, then every present probe's
    arrays; one descriptor row per entry of `probes` (absent ones zeroed)."""
    parts = [] if head is None else [np.asarray(head, np.int32)]
    off = sum(p.size for p in parts)

    def put(a: np.ndarray | None) -> int:
        nonlocal off
        if a is None:
            return -1
        parts.append(np.asarray(a, np.int32))
        start, off = off, off + a.size
        return start

    rows = []
    for p in probes:
        if p is None:
            rows.append((0, 0, 0, -1, -1, -1, 0, 0))
            continue
        rows.append((p.mul, p.lg_b, p.lg_r, put(p.disp), put(p.keys),
                     put(p.vals), 1, 0))
    arena = np.concatenate(parts) if parts else np.zeros(1, np.int32)
    return Packed(arena=torch.from_numpy(arena).to(device),
                  desc=torch.from_numpy(desc_array(rows)).to(device),
                  rows=rows)


def desc_array(rows: list[tuple[int, ...]]) -> np.ndarray:
    """The descriptor rows as the kernels read them: int32[len(rows),
    DESC_WORDS], the multiplier's uint32 bits as int32."""
    return np.array([[_i32(r[0])] + list(r[1:]) for r in rows],
                    dtype=np.int32).reshape(-1, DESC_WORDS)


# --------------------------------------------------------------------------
# plain torch probes: keys are int64 tensors holding uint32 values
# --------------------------------------------------------------------------

def mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for x < 2^32, without int64 overflow: the product
    is split at 16 bits of the multiplier (each half stays below 2^48)."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def unsigned(arena: torch.Tensor) -> torch.Tensor:
    """int32 arena -> int64 tensor of the uint32 words (the plain probes
    compare key words at 32 bits, as the kernels do)."""
    return arena.to(torch.int64) & U32


def slot(arena_u: torch.Tensor, row: tuple, key: torch.Tensor) -> torch.Tensor:
    mul, lg_b, lg_r, disp_off = row[0], row[1], row[2], row[3]
    prod = mul32(key, mul)
    rmask = (1 << lg_r) - 1
    if disp_off < 0:
        return (prod >> (32 - lg_r)) & rmask
    bk = (prod >> (32 - lg_b)) & ((1 << lg_b) - 1)
    h1 = (prod >> (32 - lg_b - lg_r)) & rmask
    return (h1 ^ arena_u[disp_off + bk]) & rmask


def probe(arena_u: torch.Tensor, row: tuple, key: torch.Tensor):
    """Exact probe -> (hit, value) tensors."""
    s = slot(arena_u, row, key)
    return arena_u[row[4] + s] == key, arena_u[row[5] + s]

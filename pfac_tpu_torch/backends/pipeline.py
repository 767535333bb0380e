"""The device pipeline end to end: sieve, compaction, deep tier, result in
place.

Counterpart of ``pfac_tpu.backends.pallas_sieve.build_pipeline``. K1 writes
the exact depth-1..3 result of every position, the survivor bitmap and the
survivors of every block. The deep tier then writes matches of >= 4 bytes
into K1's result in place:

* walk-table tier: the dense-block escape (K3, ``block_walk.py``) walks
  every position of each block where at least a quarter of the positions
  survive; the compaction (``compact.py``) lists the survivors of the other
  blocks in ascending order and K2 (``walk.py``) walks all of them in one
  launch;
* CSR tier (rulesets the walk tables cannot hold): compaction of every
  survivor, then the CSR walk (``csr_walk.py``) in one launch.

Nothing on the path waits for the device: the compaction leaves the
survivor count on the device, in a 1-element tensor beside a positions
buffer sized without it, and the walkers read it there. The tables'
placements and launch plans are kept with the tables.

The reference gates its escape on ``max_len + 4 <= HALO_ROWS * LANES``: its
K3 stages a block and a fixed lookahead in VMEM. K3 here stages tiles whose
lookahead follows the walk's depth, so the escape is armed whenever the
walk tables exist: their 6 MB tier gate stops at ~770 steps (patterns of
~1.5 KB), where the lookahead, the descriptor rows and the entry tables
still fit a CTA's shared memory.

The reference's round machinery (light/heavy rounds, ``HEAVY_CAP``,
``R_BUF_ROUNDS``, ``PER_IDX_ROUNDS``, the deferred scatter buffer) and the
CSR walker's capacity-staged pruning exist for XLA's static shapes and are
not ported: one launch takes any survivor count and walks every survivor to
full depth, so neither tier has a stage capacity or an overflow to report.
"""
from __future__ import annotations

import torch

from . import block_walk as block_walk_mod
from . import compact as compact_mod
from . import csr_walk as csr_walk_mod
from . import sieve as sieve_mod
from . import walk as walk_mod
from .probe import Packed


def run(data: torch.Tensor, n: int, npad: int, sieve_tabs: Packed,
        walk_tabs: Packed | None = None, csr_tabs: Packed | None = None, *,
        block: int = sieve_mod.BLOCK, escape: bool = True,
        plain: bool = False) -> torch.Tensor:
    """uint8 data (>= n bytes) -> int32[npad] longest-match IDs (0 at and
    past n). The walk tables take precedence over the CSR tables; with
    neither, the sieve's result is complete. `block` is the escape's block
    of positions; `escape=False` disarms it (every survivor goes to K2).
    `plain=True` runs the plain torch versions on the data's device instead
    of the kernels (the reference the card run checks)."""
    sieve = sieve_mod.sieve_plain if plain else sieve_mod.sieve
    match, bits, counts = sieve(data, n, npad, sieve_tabs, block)
    if walk_tabs is None and csr_tabs is None:
        return match
    armed = walk_tabs is not None and escape
    if armed:
        bw = (block_walk_mod.block_walk_plain if plain
              else block_walk_mod.block_walk)
        bw(data, n, counts, match, walk_tabs)
    # no block reaches block + 1 survivors: disarmed, nothing is skipped
    thresh = block // block_walk_mod.DENSE_ESCAPE_DIV if armed else block + 1
    if plain:
        pos, count = compact_mod.compact_plain(bits, counts, thresh), None
        walk, csr = walk_mod.walk_plain, csr_walk_mod.csr_walk_plain
    else:           # the count stays on the device: no host round trip
        pos, count = compact_mod.compact(bits, counts, thresh)
        walk, csr = walk_mod.walk, csr_walk_mod.csr_walk
    if walk_tabs is not None:
        walk(data, n, pos, match, walk_tabs, count)
    else:
        csr(data, n, pos, match, csr_tabs, count)
    return match

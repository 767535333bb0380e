"""E2 on the card: the per-lane gather micro-benchmark
(``experiments/gather_micro.py``), and the same probe over the port's own
tables.

E2 looks words up in the 257 x 257 pair table (66,049 words, padded to
66,560) through G1. ``take_flat`` (8K indices), ``take_2d`` (the table as
(520, 128), the indices as (64, 128): the same flat gather) and
``take_grid_4M`` (4M indices) run with its first 58,112 words in shared
memory and the rest read through L1 (``prefix``, the placement G1 takes
for it by default), split over a 2-CTA cluster's shared memory
(``cluster``), read through L1 (``ldg``) and from L2 (``cg``); at 266,240 B
the table does not fit in one CTA's shared memory, so ``smem`` is refused.
The reference's XLA baseline
(``try_xla_take_baseline``, the same lookups as ``take_flat``) becomes the
plain version, ``table[idx]``, timed beside the kernel on every line.

The arena sweep runs G1 in every placement that fits and in its default
one, and G3 with a chain
of 4 hashed steps (the walks' pattern), with 16M uniform random word
indices over the four arenas the port builds: the Snort ruleset's sieve
arena and walk tables (the layout K2 and K3 read, its values two to a
word: 199,856 B) and the 100K-signature ruleset's sieve and CSR arenas.

    python -m pfac_tpu_torch.experiments.gather_micro   # from the repo root
"""
from __future__ import annotations

import sys
from typing import Iterator

import numpy as np
import torch

from . import gathers
from .harness import Case, Refusal, main as _main, word_cases

TABLE_N = 66049            # pair table size (257 * 257)
TABLE_PAD = 66560          # padded to 520 * 128
ROWS, COLS = 520, 128
TILE = 8 * 1024
BIG = 4 << 20
N_ARENA = 16 << 20
CHAIN = 4
POSITIONS = 128 << 20      # K1's positions per call on a 128 MB corpus


def _pair(label: str, dev, idx: np.ndarray) -> Iterator[Case | Refusal]:
    table = torch.arange(TABLE_PAD, dtype=torch.int32, device=dev)
    # the table is arange, so every lookup returns its index
    yield from word_cases(label, table, torch.from_numpy(idx).to(dev), idx)


def case_take_flat(dev, n_idx: int = TILE) -> Iterator[Case | Refusal]:
    rng = np.random.default_rng(0)
    idx = rng.integers(0, TABLE_N, size=(n_idx,)).astype(np.int32)
    yield from _pair(f"E2 take_flat {n_idx}", dev, idx)


def case_take_2d(dev, n_idx: int = TILE) -> Iterator[Case | Refusal]:
    rng = np.random.default_rng(0)
    idx = rng.integers(0, TABLE_N, size=(n_idx // 128, 128)).astype(np.int32)
    yield from _pair(f"E2 take_2d ({ROWS},{COLS}) table {n_idx}", dev, idx)


def case_take_grid(dev, n_idx: int = BIG) -> Iterator[Case | Refusal]:
    rng = np.random.default_rng(0)
    idx = rng.integers(0, TABLE_N, size=(n_idx,)).astype(np.int32)
    yield from _pair(f"E2 take_grid {n_idx}", dev, idx)


def cases(dev, n_idx: int = TILE, big: int = BIG) -> Iterator[Case | Refusal]:
    yield from case_take_flat(dev, n_idx)
    yield from case_take_2d(dev, n_idx)
    yield from case_take_grid(dev, big)


def chain_expect(table: np.ndarray, idx: np.ndarray, chain: int) -> np.ndarray:
    """numpy oracle of G3's hashed chain."""
    t = table.view(np.uint32).astype(np.uint64)
    v = idx.astype(np.uint64)
    for _ in range(chain):
        h = ((t[v] ^ v) * np.uint64(gathers.CHAIN_MUL)) & np.uint64(0xFFFFFFFF)
        v = (h * np.uint64(table.size)) >> np.uint64(32)
    return v.astype(np.int32)


def arenas_of(eng, engb) -> dict[str, torch.Tensor]:
    """The four arenas of a Snort-scale engine (walk-table tier: its sieve
    arena and its walk tables as K2 and K3 read them) and a 100K-signature
    engine (CSR tier)."""
    return {"snort_sieve": eng._sieve.arena, "snort_walk": eng._walk.arena,
            "100k_sieve": engb._sieve.arena, "100k_csr": engb._csr.arena}


def arena_cases(arenas: dict[str, torch.Tensor],
                n_idx: int = N_ARENA) -> Iterator[Case | Refusal]:
    for name, arena in arenas.items():
        host = arena.cpu().numpy()
        rng = np.random.default_rng(0)
        idx = rng.integers(0, host.size, size=n_idx).astype(np.int32)
        i = torch.from_numpy(idx).to(arena.device)
        label = f"arena {name} ({host.size * 4} B)"
        yield from word_cases(f"{label} G1", arena, i, host[idx])
        yield from word_cases(f"{label} G3 chain={CHAIN} hashed", arena, i,
                              chain_expect(host, idx, CHAIN), ("smem", "ldg"),
                              chain=CHAIN, hashed=True)


def k1_loads(rows) -> int:
    """Table words K1 (csrc/sieve.cu) loads per position at rd > 3: m1's
    one, then per present probe the displacement (CHD tables), the key
    (exact tables) and the value or residual. The descriptor (21 words per
    4 positions) comes on top, warp-uniform."""
    # a row: [mul, lg_b, lg_r, disp_off, key_off, val_off, present, 0]
    return 1 + sum((r[3] >= 0) + (r[4] >= 0) + 1 for r in rows if r[6])


def port_arenas(dev) -> tuple[dict[str, torch.Tensor], dict[str, int]]:
    """Build both rulesets as chip_smoke.py does; -> (arenas, K1 loads per
    position per ruleset)."""
    import pfac_tpu_torch as pt

    from .rulesets import clamav_like_patterns, snort_like_patterns

    eng = pt.Matcher(snort_like_patterns(), device=dev)._engine()
    engb = pt.Matcher(clamav_like_patterns(np.random.default_rng(7)),
                      device=dev)._engine()
    return arenas_of(eng, engb), {"snort": k1_loads(eng._sieve.rows),
                                  "100k": k1_loads(engb._sieve.rows)}


def _all(dev) -> Iterator[Case | Refusal]:
    yield from cases(dev)
    arenas, loads = port_arenas(dev)
    print(f"K1 table loads per position: {loads}; x {POSITIONS} positions",
          flush=True)
    yield from arena_cases(arenas)


def main() -> int:
    return _main(_all)


if __name__ == "__main__":
    sys.exit(main())

"""E3 on the card: the dynamic-gather micro-benchmark
(``experiments/dyngather_micro.py``): ``v = col[v]`` from a table of
``rows`` words (the reference's lane-replicated (rows, 128) table holds
one word per row), 16M indices, through G3 with the table in shared memory
and through L1. Chain 1 at every size, and chain 4 (four dependent loads:
the walk's pattern) at 4096 rows. The reference's two TPU tile sizes have
no counterpart: the card's launch is one wave of persistent CTAs.

    python -m pfac_tpu_torch.experiments.dyngather_micro
"""
from __future__ import annotations

import sys
from typing import Iterator

import numpy as np
import torch

from .harness import Case, Refusal, main as _main, word_cases

N_IDX = 16 << 20
ROWS = (264, 1024, 4096, 8192, 16384)


def case_chain(rows: int, dev, n_idx: int = N_IDX,
               chain: int = 1) -> Iterator[Case | Refusal]:
    rng = np.random.default_rng(0)
    col = rng.integers(0, rows, size=rows).astype(np.int32)
    idx = rng.integers(0, rows, size=(n_idx // 128, 128)).astype(np.int32)
    expect = col[idx]
    for _ in range(chain - 1):
        expect = col[expect]
    yield from word_cases(f"E3 rows={rows} chain={chain}",
                          torch.from_numpy(col).to(dev),
                          torch.from_numpy(idx).to(dev), expect,
                          ("smem", "ldg"), chain=chain)


def cases(dev, n_idx: int = N_IDX) -> Iterator[Case | Refusal]:
    for rows in ROWS:
        yield from case_chain(rows, dev, n_idx)
    yield from case_chain(4096, dev, n_idx, chain=4)


def main() -> int:
    return _main(cases)


if __name__ == "__main__":
    sys.exit(main())

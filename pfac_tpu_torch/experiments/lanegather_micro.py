"""E1 on the card: the lane-gather micro-benchmark
(``experiments/lanegather_micro.py``), at the reference's sizes.

* A: ``out[i, j] = t[i % 8, idx[i, j]]`` on an (8, 128) tile, G2 along
  axis 1. The reference's own check of this case is wrong: it expects the
  rows in the order 0, 0, 1, 1, ... (``np.broadcast_to(tab[:, None, :],
  (8, 2, 128))``) while its kernel reads row ``i & 7``. The expectation
  here is ``take_along_axis`` over the tiled table.
* C and D: a word lookup from a W-word table (W = 1024, 2048, 4096), which
  the TPU laid out as vregs (C) or as lane-replicated planes (D). On the
  card both are one G1 gather over the flat table, run for every
  placement and the default one and printed once as "C/D".

    python -m pfac_tpu_torch.experiments.lanegather_micro
"""
from __future__ import annotations

import sys
from typing import Iterator

import numpy as np
import torch

from .harness import (Case, Refusal, main as _main, tile_case,
                      word_cases)

LANES = 128
N_IDX = 16 << 20
WORDS = (1024, 2048, 4096)


def case_lane_gather(dev, n_idx: int = N_IDX) -> Case:
    rng = np.random.default_rng(0)
    tab = rng.integers(0, 1 << 20, size=(8, LANES)).astype(np.int32)
    idx = rng.integers(0, LANES, size=(n_idx // LANES, LANES)).astype(np.int32)
    expect = np.take_along_axis(np.tile(tab, (idx.shape[0] // 8, 1)), idx,
                                axis=1)
    return tile_case("E1 A lane_gather (8,128) tile, axis 1",
                     torch.from_numpy(tab).to(dev),
                     torch.from_numpy(idx).to(dev), 1, expect)


def case_word_lookup(w_words: int, dev,
                     n_idx: int = N_IDX) -> Iterator[Case | Refusal]:
    """C and D at W words (the table padded to 1024 words, as C pads it
    to whole vregs; D draws the same table when W % 1024 == 0)."""
    rng = np.random.default_rng(0)
    flat = rng.integers(0, 1 << 20,
                        size=-(-w_words // 1024) * 1024).astype(np.int32)
    idx = rng.integers(0, w_words, size=(n_idx // LANES, LANES)).astype(np.int32)
    t, i = torch.from_numpy(flat).to(dev), torch.from_numpy(idx).to(dev)
    yield from word_cases(f"E1 C/D word lookup W={w_words} (one G1 gather)",
                          t, i, flat[idx])


def cases(dev, n_idx: int = N_IDX) -> Iterator[Case | Refusal]:
    yield case_lane_gather(dev, n_idx)
    for w in WORDS:
        yield from case_word_lookup(w, dev, n_idx)


def main() -> int:
    return _main(cases)


if __name__ == "__main__":
    sys.exit(main())

"""E6 on the card: the sublane-replicated plane micro-benchmark
(``experiments/lanegather2_micro.py``).

* The lane-gather semantics check, ``take_along_axis(t, idx, axis=1)`` on
  one (8, 128) tile: G2 along axis 1.
* The planes sweep, a word lookup from W = 128 ... 8192 words with 16M
  indices: one G1 gather over the flat table, for every placement and
  the default one. The
  reference's ``expand_planes`` is a TPU layout and has no counterpart.

    python -m pfac_tpu_torch.experiments.lanegather2_micro
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
WORDS = (128, 512, 1024, 2048, 4096, 8192)


def case_lane_gather_correct(dev) -> Case:
    rng = np.random.default_rng(1)
    t = rng.integers(0, 1 << 20, size=(8, LANES)).astype(np.int32)
    idx = rng.integers(0, LANES, size=(8, LANES)).astype(np.int32)
    return tile_case("E6 lane-gather semantics (8,128) axis 1",
                     torch.from_numpy(t).to(dev),
                     torch.from_numpy(idx).to(dev), 1,
                     np.take_along_axis(t, idx, axis=1))


def case_planes(w_words: int, dev,
                n_idx: int = N_IDX) -> Iterator[Case | Refusal]:
    rng = np.random.default_rng(0)
    flat = rng.integers(0, 1 << 20, size=w_words).astype(np.int32)
    idx = rng.integers(0, w_words, size=(n_idx // LANES, LANES)).astype(np.int32)
    yield from word_cases(f"E6 planes W={w_words} (one G1 gather)",
                          torch.from_numpy(flat).to(dev),
                          torch.from_numpy(idx).to(dev), flat[idx])


def cases(dev, n_idx: int = N_IDX) -> Iterator[Case | Refusal]:
    yield case_lane_gather_correct(dev)
    for w in WORDS:
        yield from case_planes(w, dev, n_idx)


def main() -> int:
    return _main(cases)


if __name__ == "__main__":
    sys.exit(main())

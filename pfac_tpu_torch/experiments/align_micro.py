"""E4 on the card: the walker's window-align micro-benchmark
(``experiments/align_micro.py``) on its 64K-survivor geometry (W_OUT 26,
ROW_WORDS 32, W_RAW 64), through G4. The reference's two variants, a
32-way select chain (``base``) and a select tree (``tree``), give one
output; on the card both are the same direct indexed load, so one kernel
serves them.

    python -m pfac_tpu_torch.experiments.align_micro
"""
from __future__ import annotations

import sys
from typing import Iterator

import numpy as np
import torch

from . import gathers
from .harness import Case, main as _main

CAP = 1 << 16
W_OUT = 26          # max_len 97 geometry (the bench ruleset)
ROW_WORDS = 32
W_RAW = 64


def align_expect(pos2d: np.ndarray, raw: np.ndarray) -> np.ndarray:
    g = pos2d.shape[0] // 8
    wv = (pos2d.reshape(g, 1, 8, 128) & 127) >> 2
    rows = np.arange(W_OUT).reshape(1, -1, 1, 1) + wv
    return np.take_along_axis(raw.reshape(g, -1, 8, 128), rows,
                              axis=1).reshape(-1, 128)


def case_align(dev, survivors: int = CAP) -> Case:
    rng = np.random.default_rng(0)
    g = survivors // 1024
    pos2d = rng.integers(0, 1 << 26, size=(g * 8, 128)).astype(np.int32)
    raw = rng.integers(-(1 << 31), 1 << 31, size=(g * W_RAW * 8, 128),
                       dtype=np.int64).astype(np.int32)
    p, r = torch.from_numpy(pos2d).to(dev), torch.from_numpy(raw).to(dev)
    return Case(f"E4 align base/tree {survivors} survivors, W_OUT={W_OUT}",
                "align_kernel", survivors * W_OUT,
                lambda: gathers.align(p, r, W_OUT),
                lambda: gathers.align_plain(p, r, W_OUT),
                align_expect(pos2d, raw),
                # positions in; each output word read from raw and written
                pos2d.nbytes + 2 * 4 * survivors * W_OUT)


def cases(dev, survivors: int = CAP) -> Iterator[Case]:
    yield case_align(dev, survivors)


def main() -> int:
    return _main(cases)


if __name__ == "__main__":
    sys.exit(main())

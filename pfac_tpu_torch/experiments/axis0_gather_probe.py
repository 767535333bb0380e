"""E5 on the card: the axis-0 (sublane) gather probe
(``experiments/axis0_gather_probe.py``). Mosaic lowered none of its three
shapes on the TPU; on the card each is one G2 gather along axis 0, the
tile read directly (a, c) or its 32-column strips staged in shared memory
(b), as ``gathers.tile_path`` rules:

* a: (8, 128) indices into a (512, 128) tile (the walker's shape);
* b: (512, 128) indices into (512, 128);
* c: (8, 128) indices into a (32, 128) window.

    python -m pfac_tpu_torch.experiments.axis0_gather_probe
"""
from __future__ import annotations

import sys
from typing import Iterator

import numpy as np
import torch

from .harness import Case, main as _main, tile_case


def _case(name: str, raw: np.ndarray, idx: np.ndarray, dev,
          path: str | None) -> Case:
    return tile_case(name, torch.from_numpy(raw).to(dev),
                     torch.from_numpy(idx).to(dev), 0,
                     np.take_along_axis(raw, idx, axis=0), path)


def cases(dev, paths: tuple = (None,)) -> Iterator[Case]:
    """The three shapes, each on every path of `paths` (None: the
    wrapper's rule; "direct" or "staged": forced)."""
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 1000, size=(512, 128)).astype(np.int32)
    idx8 = (rng.integers(0, 64, size=(8, 128)).astype(np.int32)) * 8 \
        + np.arange(8, dtype=np.int32)[:, None]
    idx512 = (rng.integers(0, 64, size=(512, 128)).astype(np.int32)) * 8 \
        + (np.arange(512, dtype=np.int32)[:, None] % 8)
    idx8s = (rng.integers(0, 4, size=(8, 128)).astype(np.int32)) * 8 \
        + np.arange(8, dtype=np.int32)[:, None]
    for path in paths:
        yield _case("E5 a_axis0_8from512", raw, idx8, dev, path)
        yield _case("E5 b_axis0_512from512", raw, idx512, dev, path)
        yield _case("E5 c_axis0_8from32", np.ascontiguousarray(raw[:32]),
                    idx8s, dev, path)


def main() -> int:
    return _main(cases)


if __name__ == "__main__":
    sys.exit(main())

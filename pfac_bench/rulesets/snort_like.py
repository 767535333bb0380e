"""Snort-scale network IDS ruleset: the statistics of Snort V2.8 in the
PFAC paper (Lin et al., IEEE Trans. Computers 2013, section 6.1: 1,998
patterns, lengths 1-243 skewed short, text and binary bytes).

Params: ``seed``, ``patterns`` (how many to draw). Lengths ``gamma(2.2, 9)
+ 1`` clipped to 1-243; 70% printable (32-126), the rest any byte;
duplicates dropped, first kept. The draws interleave per pattern, as in the
generator every earlier measurement of the program used, so seed 42 gives
the same 2,000 patterns (40,860 bytes); 2,000 draws cost milliseconds.
"""
from __future__ import annotations

import numpy as np


def make(params: dict) -> list[bytes]:
    rng = np.random.default_rng(params["seed"])
    pats = []
    for _ in range(params["patterns"]):
        ln = int(np.clip(rng.gamma(shape=2.2, scale=9.0) + 1, 1, 243))
        if rng.random() < 0.7:
            p = rng.integers(32, 127, size=ln, dtype=np.int64)
        else:
            p = rng.integers(0, 256, size=ln, dtype=np.int64)
        pats.append(bytes(p.astype(np.uint8)))
    return list(dict.fromkeys(pats))

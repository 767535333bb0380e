"""Corpus generators, one file a kind (``corpora/<kind>.py``), and what
they share: the patterns packed into one array, and planting copies of them
into a buffer.

A generator's ``make(params, patterns, n, rng, gen, device)`` returns a
uint8 tensor of n bytes on `device`. `rng` (numpy) draws the small things
(which patterns, where), `gen` (a ``torch.Generator`` on `device`) the
bulk bytes, in a few large calls on the device: one seed gives one corpus
on a given card and torch version.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def packed(patterns: Sequence[bytes]) -> tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
    """-> (every pattern's bytes concatenated, starts, lengths)."""
    lens = np.fromiter(map(len, patterns), dtype=np.int64,
                       count=len(patterns))
    starts = np.zeros_like(lens)
    starts[1:] = np.cumsum(lens)[:-1]
    return np.frombuffer(b"".join(patterns), dtype=np.uint8), starts, lens


def draw_until(rng: np.random.Generator, lens: np.ndarray,
               total: int) -> np.ndarray:
    """Pattern indices drawn uniformly until their lengths reach `total`
    (the last one crossing it included)."""
    picks = np.zeros(0, dtype=np.int64)
    step = int(total / lens.mean() * 1.1) + 16
    while lens[picks].sum() < total:
        picks = np.concatenate([picks, rng.integers(0, lens.size, size=step)])
    cut = int(np.searchsorted(np.cumsum(lens[picks]), total)) + 1
    return picks[:cut]


def plant(buf: torch.Tensor, patterns: Sequence[bytes], share: float,
          rng: np.random.Generator) -> int:
    """Overwrite `share` of `buf`'s bytes with whole copies of patterns
    drawn uniformly, at random offsets that never overlap (each copy is
    intact) -> the number of copies."""
    n = buf.numel()
    budget = int(n * share)
    if budget <= 0:
        return 0
    flat, starts, lens = packed(patterns)
    picks = draw_until(rng, lens, budget)
    ln = lens[picks]
    free = n - int(ln.sum())
    if free < 0:
        raise ValueError("the planted copies do not fit the buffer")
    before = np.cumsum(ln) - ln
    offs = np.sort(rng.integers(0, free + 1, size=picks.size)) + before
    within = np.arange(int(ln.sum()), dtype=np.int64) - np.repeat(before, ln)
    dst = np.repeat(offs, ln) + within
    src = np.repeat(starts[picks], ln) + within
    buf[torch.from_numpy(dst).to(buf.device)] = \
        torch.from_numpy(flat[src]).to(buf.device)
    return int(picks.size)

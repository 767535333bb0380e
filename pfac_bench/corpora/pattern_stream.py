"""The ruleset's own patterns, drawn uniformly and concatenated, the last
one cut: the virus-dense worst case of the PFAC library's benchmark, an
input built from the rules themselves. Every position lies inside a
pattern copy, so the sieve lets several percent of them through and the
survivor walk sets the pace.

Params: none besides ``bytes``. `rng` draws the patterns; their bytes are
gathered on `device` in a few large calls (`gen` is not used: no byte is
random).
"""
from __future__ import annotations

import torch

from pfac_bench.corpora import draw_until, packed


def make(params, patterns, n, rng, gen, device) -> torch.Tensor:
    flat, starts, lens = packed(patterns)
    picks = draw_until(rng, lens, n)
    ln = torch.from_numpy(lens[picks]).to(device)
    # byte i of the output is flat[starts[pick] + i - (the pick's offset)]
    shift = torch.from_numpy(starts[picks]).to(device) - (
        torch.cumsum(ln, 0) - ln)
    src = torch.repeat_interleave(shift, ln, output_size=int(
        lens[picks].sum()))[:n]
    src += torch.arange(n, dtype=torch.int64, device=device)
    return torch.from_numpy(flat.copy()).to(device)[src]

"""One byte repeated: the PFAC library's Benchmark I input (100M of 'a',
or of 'b'), made on `device` in one call.

Params: ``byte`` (0-255) besides ``bytes``. It draws nothing from the
seed (`rng` and `gen` are not used): the source's input is one constant
buffer, so every seed gives the same corpus.
"""
from __future__ import annotations

import torch


def make(params, patterns, n, rng, gen, device) -> torch.Tensor:
    return torch.full((n,), params["byte"], dtype=torch.uint8, device=device)

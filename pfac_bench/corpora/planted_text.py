"""Text with a share of its bytes planted pattern copies, a stand-in for
network payloads.

Params: ``planted_share``; ``low``, ``high`` (the text's byte range, high
exclusive; default 32-127, printable ASCII).
"""
from __future__ import annotations

import torch

from pfac_bench.corpora import plant


def make(params, patterns, n, rng, gen, device) -> torch.Tensor:
    buf = torch.randint(params.get("low", 32), params.get("high", 127), (n,),
                        generator=gen, device=device, dtype=torch.uint8)
    plant(buf, patterns, params["planted_share"], rng)
    return buf

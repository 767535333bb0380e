"""``Matcher.match_device(batch)``: a uint8 tensor on the card in, int32
IDs out, one a position, padded with zeros to the program's bucket
(``PFAC_matchFromDevice``). The request ends when the stream has reached
the call's end."""
from __future__ import annotations

import torch

#: positions (< n) whose ID differs from the reference; nonzero words past n
LIMITS = {"wrong_ids": 0, "tail_nonzero": 0}


class Op:
    def __init__(self, matcher, device: torch.device, slots: int):
        self.matcher = matcher

    def call(self, batch: torch.Tensor):
        return self.matcher.match_device(batch)

    def readback(self, out, slot: int) -> None:
        pass

    def complete(self, out, slot: int) -> int | None:
        return None


def compare(out: torch.Tensor, ref: torch.Tensor, n: int) -> dict[str, int]:
    out = out.flatten()
    m = min(n, out.numel())
    wrong = int((out[:m] != ref[:m].to(out.device)).sum()) + (n - m)
    return {"wrong_ids": wrong, "tail_nonzero": int((out[n:] != 0).sum())}

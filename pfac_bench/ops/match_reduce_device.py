"""``Matcher.match_reduce_device(batch)``: the compacted alerts, ``(ids,
positions, count)`` on the card, npad-long arrays with zeros past the 0-d
``count`` (``PFAC_matchFromDeviceReduce``). The request ends when the count
has been read to the host, which a caller needs before it can copy the
alerts."""
from __future__ import annotations

import torch

#: |count - the reference's|; entries below both counts whose (ID,
#: position) differs; nonzero words past the count in either array
LIMITS = {"count_gap": 0, "wrong_pairs": 0, "past_count_nonzero": 0}


class Op:
    def __init__(self, matcher, device: torch.device, slots: int):
        self.matcher = matcher
        pin = device.type == "cuda"
        self.count = [torch.zeros((), dtype=torch.int32, pin_memory=pin)
                      for _ in range(slots)]

    def call(self, batch: torch.Tensor):
        return self.matcher.match_reduce_device(batch)

    def readback(self, out, slot: int) -> None:
        self.count[slot].copy_(out[2], non_blocking=True)

    def complete(self, out, slot: int) -> int | None:
        return int(self.count[slot])


def compare(out, ref: torch.Tensor, n: int) -> dict[str, int]:
    ids, pos, count = (t.flatten() for t in out)
    got = int(count[0])
    ref = ref.to(ids.device)
    ref_pos = torch.nonzero(ref).flatten()
    want = int(ref_pos.numel())
    m = max(0, min(got, want, ids.numel(), pos.numel()))
    wrong = ((ids[:m] != ref[ref_pos[:m]])
             | (pos[:m].long() != ref_pos[:m])).sum()
    past = max(0, got)
    tail = int((ids[past:] != 0).sum()) + int((pos[past:] != 0).sum())
    return {"count_gap": abs(got - want), "wrong_pairs": int(wrong),
            "past_count_nonzero": tail}

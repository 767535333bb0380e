"""The control of the comparison that decides ``correct``, and the program's
own readings beside it, at a cell's full size on the card.

The system states no precision; the control breaks one guarantee that every
configuration states, "the longest pattern starting at each position": it
is the plain reference put in the program's place with every walk stopped
after ``CAP`` bytes, as a matcher that bounds its walks would. The
comparison has to find it wrong on every seed, while the program reads 0.

    python3 pfac_bench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 2]

runs the cell's set-up, a short window and the check once a seed, the
program's seeds first, then the control's, in one process (the program's
handle is built once: its ruleset does not depend on the seed). Prints a
JSON line a seed and last the readings: for each number compared the
largest the program gave (the lower reading) and the smallest the control
gave (the upper reading). Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))

from pfac_bench import harness, reference  # noqa: E402
from pfac_bench.layout import Bench  # noqa: E402

CAP = 32    # bytes a control walk takes at most


class ControlMatcher:
    """The reference in the program's place, every walk cut at `cap`."""

    def __init__(self, patterns: list[bytes], device: torch.device,
                 cap: int = CAP):
        self.trie = reference.build(patterns)
        self.cap = cap

    def match_device(self, batch: torch.Tensor) -> torch.Tensor:
        return reference.match_dense(self.trie, batch, max_depth=self.cap)

    def match_reduce_device(self, batch: torch.Tensor):
        dense = self.match_device(batch)
        ids, pos, count = reference.reduce_form(dense)
        out_ids = torch.zeros_like(dense)
        out_pos = torch.zeros_like(dense)
        out_ids[:count] = ids
        out_pos[:count] = pos
        return out_ids, out_pos, torch.tensor(count, dtype=torch.int32,
                                               device=dense.device)


def readings(bench: Bench, cell: str, seeds: list[int],
             control_seeds: list[int], seconds: float,
             device: torch.device, overrides: dict | None = None,
             emit=print) -> dict:
    """Run the program on `seeds` and the control on `control_seeds` ->
    {"lower": {number: max over the program}, "upper": {number: min over
    the control}, "program_correct": [...], "control_correct": [...]}."""
    cached: dict = {}

    def program(patterns, dev):
        if "m" not in cached:
            cached["m"] = harness.port_matcher(patterns, dev)
        return cached["m"]

    out: dict = {"lower": {}, "upper": {}, "program_correct": [],
                 "control_correct": []}
    for who, factory, group in (("program", program, seeds),
                                ("control", ControlMatcher, control_seeds)):
        for seed in group:
            run = harness.run_cell(bench, cell, seed, seconds, False, device,
                                   matcher_factory=factory,
                                   overrides=overrides, log=lambda _m: None)
            emit(json.dumps({"who": who, "seed": seed,
                             "correct": run.correct,
                             "requests": run.window.completed,
                             "checks": run.checks}))
            out[f"{who}_correct"].append(run.correct)
            side, pick = (("lower", max) if who == "program"
                          else ("upper", min))
            for k, v in run.checks.items():
                out[side][k] = pick(out[side].get(k, v), v)
    return out


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="pfac_bench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    res = readings(Bench.load(), args.workload, ints(args.seeds),
                   ints(args.control_seeds), args.seconds,
                   torch.device("cuda", 0))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

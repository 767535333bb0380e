"""The device's timeline from ``torch.profiler``: busy intervals, idle gaps
and what the host was doing in each.

The benchmark marks the traced window with one ``record_function`` span;
the profiler's trace puts it on one clock with the card's kernels, copies
and memsets and with the host's aten ops and CUDA runtime calls. A span in
every request would cost the host more than the program's own call
(measured on the card), so the idle gaps are labelled by the host op that
overlaps each most. Everything here is plain arithmetic on ``(start, end)``
pairs in seconds, so the tests check it on hand-made intervals.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Callable, Iterable

WINDOW = "pfac_bench.window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver"}
PYTHON = "python between traced ops"


@dataclasses.dataclass
class TraceSummary:
    window_s: float                      # the traced window's length
    busy_s: float                        # the union of device activity in it
    device_ops: list[tuple[str, float]]  # seconds by op name, most first
    idle_gaps: list[tuple[str, float]]   # idle seconds by host op, most first
    device_events: int                   # device activities in the window


def union(intervals: Iterable[tuple[float, float]]) -> list[tuple[float,
                                                                  float]]:
    """Merge overlapping or touching intervals -> sorted, disjoint."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Iterable[tuple[float, float]], lo: float,
         hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def busy(intervals: Iterable[tuple[float, float]], lo: float,
         hi: float) -> float:
    """Seconds of [lo, hi] covered by at least one interval."""
    return sum(b - a for a, b in union(clip(intervals, lo, hi)))


def gaps(intervals: Iterable[tuple[float, float]], lo: float,
         hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def label_gaps(idle: list[tuple[float, float]],
               spans: list[tuple[float, float, str]]) -> dict[str, float]:
    """Idle seconds by the host op that overlaps each gap most (of equal
    overlaps the shorter, inner op; :data:`PYTHON` where none does)."""
    spans = sorted(spans)
    longest = max((s1 - s0 for s0, s1, _ in spans), default=0.0)
    out: dict[str, float] = defaultdict(float)
    j = 0
    for a, b in idle:
        while j < len(spans) and spans[j][0] + longest <= a:
            j += 1
        best, name = (0.0, 0.0), PYTHON
        k = j
        while k < len(spans) and spans[k][0] < b:
            s0, s1, what = spans[k]
            key = (min(b, s1) - max(a, s0), s0 - s1)
            if key[0] > 0 and key > best:
                best, name = key, what
            k += 1
        out[name] += b - a
    return dict(out)


def short(name: str) -> str:
    """A kernel's or op's name without ``void``, anonymous namespaces and
    its argument list."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    return name.split("(")[0].strip()[:120] or "?"


def summarize(events: list[dict]) -> TraceSummary | None:
    """A chrome trace's events -> the summary of the window span, or None
    where the trace has no window or no device activity in it."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("ph") == "X" and "gpu" not in str(e.get("cat", ""))]
    if not win:
        return None
    lo = float(win[0]["ts"]) * 1e-6
    hi = lo + float(win[0]["dur"]) * 1e-6
    dev, by_name, spans = [], defaultdict(float), []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        a = float(e["ts"]) * 1e-6
        b = a + float(e["dur"]) * 1e-6
        if cat in DEVICE_CATS:
            if b > lo and a < hi:
                dev.append((a, b))
                by_name[short(str(e.get("name", "?")))] += \
                    min(b, hi) - max(a, lo)
        elif cat in HOST_CATS and b > lo and a < hi:
            spans.append((a, b, short(str(e.get("name", "?")))))
    if not dev:
        return None
    idle = label_gaps(gaps(dev, lo, hi), spans)
    return TraceSummary(
        window_s=hi - lo, busy_s=busy(dev, lo, hi),
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1])[:10],
        device_events=len(dev))


def profile(fn: Callable[[], None]) -> TraceSummary | None:
    """Run `fn` under ``torch.profiler`` (host and card) and summarise the
    window span it marks. The trace goes to a temporary directory and is
    deleted."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as d:
        with torch.profiler.profile(activities=acts) as prof:
            fn()
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return summarize(events)

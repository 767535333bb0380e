"""The program's spans in a ``torch.profiler`` trace: one record a request,
and the card's idle time split by what the host was doing.

The program marks each request with an outermost span (``pfac.match_device``
or ``pfac.match_reduce_device``) and its layers inside it (``pfac.*``,
category ``cpu_op``). The CUDA runtime calls inside the ``pfac.program``
span carry the profiler's ``correlation`` id, and so do the device
activities they enqueue: a graph's kernels carry the id of its
``cudaGraphLaunch``. :func:`requests` makes from these one record a request;
:func:`idle_split` labels every instant of every idle gap of the card.
Both are plain arithmetic on the chrome trace's events (microseconds in,
seconds out), checked by the tests on hand-made events.

    python3 pfac_bench/spans.py --workload <cell> --seed <n> [--seconds 3]

runs the cell once with its traced window, keeps that window's events, and
prints one JSON line: the per-request records' means, the idle split a
request, both windows' ``scan_GBps`` and the traced run's result line. A
measurement tool, not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
from collections import defaultdict

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))

from pfac_bench import devtrace  # noqa: E402

OUTER = ("pfac.match_device", "pfac.match_reduce_device")
PREFIX = "pfac."
K1 = "sieve_"                 # K1: sieve_{smem,cluster,global}_kernel
WAIT = "wait"                 # in a runtime call that waits for the card
HARNESS = "harness"           # outside the program's spans and runtime calls
LAUNCH = "launch latency"     # after the call that enqueued the next activity
NONE = "unattributed"         # a gap that no enqueued activity ends


def _x(events: list[dict]):
    for e in events:
        if e.get("ph") == "X" and "dur" in e:
            a = float(e["ts"]) * 1e-6
            yield e, a, a + float(e["dur"]) * 1e-6, str(e.get("cat", ""))


def _corr(e: dict):
    return (e.get("args") or {}).get("correlation")


def requests(events: list[dict]) -> list[dict]:
    """One record a request (an outermost ``pfac.*`` span), in order:
    ``name``, ``start``, ``end`` (s); ``self`` (each ``pfac.*`` span's own
    seconds inside it, its inner spans left out); ``runtime`` (seconds in
    each CUDA runtime call inside it); ``first_k1`` (the start of the first
    K1 kernel enqueued inside it, by correlation; None where none)."""
    outer, spans, runtime, k1 = [], [], [], {}
    for e, a, b, cat in _x(events):
        name = str(e.get("name", ""))
        if cat == "cpu_op" and name.startswith(PREFIX):
            spans.append((a, b, name))
            if name in OUTER:
                outer.append((a, b, name))
        elif cat == "cuda_runtime":
            runtime.append((a, b, name, _corr(e)))
        elif cat == "kernel" and devtrace.short(name).startswith(K1):
            c = _corr(e)
            if c is not None:
                k1[c] = min(a, k1.get(c, a))
    spans.sort()
    runtime.sort()
    out = []
    for lo, hi, name in sorted(outer):
        inner = _within(spans, lo, hi)
        rt: dict[str, float] = defaultdict(float)
        starts = []
        for a, b, nm, c in _within(runtime, lo, hi):
            rt[nm] += b - a
            if c in k1:
                starts.append(k1[c])
        out.append({"name": name, "start": lo, "end": hi,
                    "self": _innermost(lo, hi, inner), "runtime": dict(rt),
                    "first_k1": min(starts) if starts else None})
    return out


def _within(items: list[tuple], lo: float, hi: float) -> list[tuple]:
    """The items (sorted by start) that lie inside [lo, hi]."""
    k = bisect.bisect_left(items, (lo,))
    out = []
    for it in items[k:]:
        if it[0] > hi:
            break
        if it[1] <= hi:
            out.append(it)
    return out


def _innermost(a: float, b: float, spans) -> dict[str, float]:
    """Seconds of [a, b] by the shortest of `spans` covering each instant
    (none: left out)."""
    pts = sorted({a, b} | {t for x, y, _ in spans for t in (x, y)
                           if a < t < b})
    out: dict[str, float] = defaultdict(float)
    for x, y in zip(pts, pts[1:]):
        mid = 0.5 * (x + y)
        cover = [s for s in spans if s[0] <= mid < s[1]]
        if cover:
            out[min(cover, key=lambda s: s[1] - s[0])[2]] += y - x
    return dict(out)


def means(records: list[dict]) -> dict:
    """The records' means in microseconds: the outer span (``call_us``),
    its start to the first K1 kernel (``dispatch_us``), each span's self
    time and each runtime call's time a request."""
    n = len(records)
    if not n:
        return {"requests": 0}
    out = {"requests": n,
           "call_us": sum(r["end"] - r["start"] for r in records) / n * 1e6}
    k1 = [r["first_k1"] - r["start"] for r in records
          if r["first_k1"] is not None]
    if k1:
        out["dispatch_us"] = sum(k1) / len(k1) * 1e6
    for key in ("self", "runtime"):
        tot: dict[str, float] = defaultdict(float)
        for r in records:
            for k, v in r[key].items():
                tot[k] += v
        out[f"{key}_us"] = {k: v / n * 1e6 for k, v in sorted(tot.items())}
    return out


def idle_split(events: list[dict], lo: float, hi: float) -> dict[str, float]:
    """The card's idle seconds in [lo, hi] (s) by what the host did:
    :data:`LAUNCH` from the return of the runtime call that enqueued the
    activity ending the gap (found by correlation) to the activity's start;
    before it, :data:`WAIT` inside a runtime call that waits for the card
    (``*Synchronize*``), the runtime call's name inside any other; inside
    the program's spans the innermost host op's name (a ``pfac.*`` span's
    own time, or an aten op it calls), else :data:`HARNESS`; :data:`NONE`
    for a gap that no enqueued activity ends (the window's last)."""
    dev, host, calls, by_corr = [], [], [], {}
    for e, a, b, cat in _x(events):
        name = str(e.get("name", ""))
        if cat.lower() in devtrace.DEVICE_CATS:
            dev.append((a, b, _corr(e)))
        elif cat == "cuda_runtime":
            calls.append((a, b, WAIT if "Synchronize" in name else name))
            if _corr(e) is not None:
                by_corr[_corr(e)] = (a, b)
        elif cat == "cpu_op":
            host.append((a, b, name))
    calls.sort()
    host.sort()
    lc = max((y - x for x, y, _ in calls), default=0.0)
    lh = max((y - x for x, y, _ in host), default=0.0)
    starts = defaultdict(list)
    for a, b, c in dev:
        starts[a].append(c)
    out: dict[str, float] = defaultdict(float)
    for a, b in devtrace.gaps([(x, y) for x, y, _ in dev], lo, hi):
        ender = [c for c in starts.get(b, []) if c in by_corr]
        if not ender or b >= hi:
            out[NONE] += b - a
            continue
        r1 = max(by_corr[c][1] for c in ender)
        if r1 < b:
            out[LAUNCH] += b - max(a, r1)
        if r1 > a:
            for k, v in _label(a, min(b, r1), calls, lc, host,
                               lh).items():
                out[k] += v
    return dict(out)


def _covering(items: list[tuple[float, float, str]], t: float,
              longest: float) -> list[tuple[float, float, str]]:
    j = bisect.bisect_right(items, (t, float("inf"), ""))
    k = bisect.bisect_left(items, (t - longest, float("-inf"), ""))
    return [it for it in items[k:j] if it[0] <= t < it[1]]


def _label(a: float, b: float, calls, lc: float, host,
           lh: float) -> dict[str, float]:
    """[a, b] by the host's state at each instant (`calls`, `host`
    sorted; `lc`, `lh` their longest)."""
    cuts = {a, b}
    for items, longest in ((calls, lc), (host, lh)):
        k = bisect.bisect_left(items, (a - longest, float("-inf"), ""))
        for x, y, _ in items[k:bisect.bisect_right(
                items, (b, float("inf"), ""))]:
            cuts.update(t for t in (x, y) if a < t < b)
    pts = sorted(cuts)
    out: dict[str, float] = defaultdict(float)
    for x, y in zip(pts, pts[1:]):
        mid = 0.5 * (x + y)
        rt = _covering(calls, mid, lc)
        if rt:
            label = WAIT if any(n == WAIT for *_, n in rt) else rt[-1][2]
        else:
            sp = _covering(host, mid, lh)
            label = (min(sp, key=lambda s: s[1] - s[0])[2]
                     if any(n.startswith(PREFIX) for *_, n in sp)
                     else HARNESS)
        out[label] += y - x
    return dict(out)


def lags(events: list[dict]) -> list[float]:
    """For each runtime call with device activity of its correlation id,
    the first activity's start less the call's start (s), sorted. None is
    below 0 where the two timelines agree: an activity cannot start before
    the call that enqueued it. A trace whose smallest lag is negative has
    the card's clock ahead of the host's, and its idle split is wrong."""
    calls, first = {}, {}
    for e, a, b, cat in _x(events):
        c = _corr(e)
        if c is None:
            continue
        if cat == "cuda_runtime":
            calls[c] = a
        elif cat.lower() in devtrace.DEVICE_CATS:
            first[c] = min(a, first.get(c, a))
    return sorted(first[c] - calls[c] for c in first if c in calls)


def window(events: list[dict]) -> tuple[float, float] | None:
    """The benchmark's traced window span (s), or None."""
    for e, a, b, cat in _x(events):
        if e.get("name") == devtrace.WINDOW and "gpu" not in cat:
            return a, b
    return None


def summary(events: list[dict]) -> dict:
    """What the tool prints of one traced window: the requests inside it
    (:func:`means`), the launch lags (:func:`lags`: their least and median,
    in us, and how many are negative), and the idle split, in seconds and
    in microseconds a request."""
    win = window(events)
    if win is None:
        return {}
    lo, hi = win
    recs = [r for r in requests(events) if lo <= r["start"] and r["end"]
            <= hi]
    split = idle_split(events, lo, hi)
    n = max(1, len(recs))
    lag = lags(events)
    return {"window_s": hi - lo, **means(recs),
            "lag_us": ({"min": lag[0] * 1e6, "median": lag[len(lag) // 2]
                        * 1e6, "negative": sum(x < 0 for x in lag),
                        "pairs": len(lag)} if lag else {}),
            "idle_s": sum(split.values()),
            "idle_split_s": dict(sorted(split.items(), key=lambda kv: -kv[1])),
            "idle_split_us_a_request": {k: v / n * 1e6 for k, v in sorted(
                split.items(), key=lambda kv: -kv[1])}}


def main(argv: list[str]) -> int:
    import torch

    from pfac_bench import harness
    from pfac_bench.layout import Bench
    p = argparse.ArgumentParser(prog="pfac_bench/spans.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("spans: no CUDA device", file=sys.stderr)
        return 2
    kept: list[list[dict]] = []
    summarize = devtrace.summarize

    def keep(events):
        kept.append(events)
        return summarize(events)

    devtrace.summarize = keep
    try:
        bench = Bench.load()
        device = torch.device("cuda", 0)
        run = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                               True, device)
    finally:
        devtrace.summarize = summarize
    line = harness.result(bench, run, True, {"platform": "gpu"})
    rate = {}
    for key, w in (("window", run.window), ("traced", run.traced)):
        if w is not None and w.seconds > 0:
            rate[key] = sum(w.nbytes) / w.seconds / 1e9
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "scan_GBps": rate, "correct": run.correct,
                      "metrics": line["metrics"],
                      "breakdown": line.get("breakdown"),
                      "spans": summary(kept[0]) if kept else {}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

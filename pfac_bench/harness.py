"""One run of one cell: set-up, the measured window, the traced window, the
check, and the result line.

A run builds the cell's ruleset and a pool of distinct batches from the
seed, copies them to the card, builds the program's handle, warms up every
shape the window uses, then calls the operation in a closed loop for the
window's seconds: each request is one call on the next batch of the pool,
and ends when the host knows its result is complete. The outputs of a
sample of the window's requests (for each pool batch the last one and one
drawn from the seed) are kept. After the window the program is freed and
the plain reference (``reference/``) recomputes each pool batch's result;
every kept output is compared with it in full.

The program under test is ``pfac_tpu_torch`` alone; this module imports it
only inside :func:`port_matcher`.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from collections import deque

import numpy as np
import torch

from . import devtrace, reference
from .layout import PKG_DIR, Bench

FORBIDDEN = {"jax", "jaxlib", "flax", "pfac_tpu"}
TRACE_WARMUP_S = 0.2        # requests run under the profiler before its window
DEFAULT_TRACE_S = 0.5       # the traced window, unless the mix says


@dataclasses.dataclass
class Window:
    """What the requests of one window did."""

    latency_ms: list[float] = dataclasses.field(default_factory=list)
    call_s: list[float] = dataclasses.field(default_factory=list)
    nbytes: list[int] = dataclasses.field(default_factory=list)
    least_bytes: list[int] = dataclasses.field(default_factory=list)
    seconds: float = 0.0        # first call to last completion
    failed: int = 0
    errors: list[str] = dataclasses.field(default_factory=list)

    @property
    def completed(self) -> int:
        return len(self.latency_ms)


@dataclasses.dataclass
class Run:
    """Everything a run measured; the metric readers read this."""

    cell: str
    setup_s: float
    engine_build_s: float
    window: Window
    traced: Window | None
    trace: devtrace.TraceSummary | None
    peak_bytes_per_s: float | None
    memory_peak_bytes: int | None
    checks: dict[str, int]
    limits: dict[str, int]

    @property
    def correct(self) -> bool:
        return all(self.checks[k] <= self.limits[k] for k in self.limits)


class Done:
    """What the host waits on to know a request's result is complete: on
    the card, an event recorded after the call and what the host reads
    back; on the CPU of the tests, nothing (calls there are synchronous)."""

    def __init__(self, device: torch.device, slots: int):
        self.ev = ([torch.cuda.Event() for _ in range(slots)]
                   if device.type == "cuda" else None)

    def mark(self, slot: int) -> None:
        if self.ev is not None:
            self.ev[slot].record()

    def wait(self, slot: int) -> None:
        if self.ev is not None:
            self.ev[slot].synchronize()


class Keeper:
    """Keeps, for each pool batch, the output of its last request and of one
    request drawn uniformly from the seed (reservoir of one)."""

    def __init__(self, pool: int, rng: np.random.Generator):
        self.rng = rng
        self.last: list = [None] * pool
        self.drawn: list = [None] * pool
        self.seen = [0] * pool

    def __call__(self, b: int, out) -> None:
        self.seen[b] += 1
        self.last[b] = out
        if self.rng.random() * self.seen[b] < 1.0:
            self.drawn[b] = out

    def outputs(self, b: int) -> list:
        kept = [o for o in (self.last[b], self.drawn[b]) if o is not None]
        return kept[:1] if len(kept) == 2 and kept[0] is kept[1] else kept


def port_matcher(patterns: list[bytes], device: torch.device):
    """The system under test: the port's handle with its default options."""
    from pfac_tpu_torch import Matcher
    return Matcher(patterns, device=str(device))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def _window(op, batches, seconds: float, depth: int, done: Done, keep,
            least_bytes) -> Window:
    """Closed loop, `depth` requests in flight, for `seconds`. A request's
    latency is the host clock from just before its call to the host knowing
    its result is complete."""
    w = Window()
    pending: deque = deque()
    pool = len(batches)
    i = 0
    t_start = time.perf_counter()
    t_stop = t_start + seconds
    t_end = t_start
    while True:
        while len(pending) < depth and time.perf_counter() < t_stop:
            b, slot = i % pool, i % depth
            i += 1
            try:
                t0 = time.perf_counter()
                out = op.call(batches[b])
                t1 = time.perf_counter()
                op.readback(out, slot)
                done.mark(slot)
            except Exception as e:  # a request that raises counts as failed
                w.failed += 1
                w.errors.append(repr(e))
                continue
            pending.append((b, slot, out, t0, t1 - t0))
        if not pending:
            break
        b, slot, out, t0, call_s = pending.popleft()
        try:
            done.wait(slot)
            matches = op.complete(out, slot)
        except Exception as e:
            w.failed += 1
            w.errors.append(repr(e))
            continue
        t_end = time.perf_counter()
        n = batches[b].numel()
        w.latency_ms.append((t_end - t0) * 1e3)
        w.call_s.append(call_s)
        w.nbytes.append(n)
        w.least_bytes.append(least_bytes(n, matches))
        keep(b, out)
    w.seconds = t_end - t_start
    return w


def _peak_bandwidth(device: torch.device) -> float | None:
    if device.type != "cuda":
        return None
    with open(os.path.join(PKG_DIR, "peaks.json")) as f:
        peaks = json.load(f)
    entry = peaks.get(torch.cuda.get_device_name(device))
    return None if entry is None else float(entry["hbm_bytes_per_s"])


def run_cell(bench: Bench, name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, *, t_process: float | None = None,
             matcher_factory=port_matcher, overrides: dict | None = None,
             log=None) -> Run:
    """One run of cell `name`. `overrides` ({"config": ..., "traffic":
    ...}, merged into the files' contents) and a CPU `device` are for the
    tests; `matcher_factory(patterns, device)` puts another matcher in the
    program's place (the control, the tests' faults)."""
    t_process = time.time() if t_process is None else t_process
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    overrides = overrides or {}
    cell = bench.cell(name)
    config = _merge(bench.config(cell["config"]), overrides.get("config", {}))
    traffic = _merge(bench.traffic(cell["traffic"]),
                     overrides.get("traffic", {}))
    op_name = traffic["op"]
    op_mod = bench.module("ops", op_name)
    least_bytes = bench.module("bytecount", op_name).least_bytes
    corpus = traffic["corpus"]
    make_corpus = bench.module("corpora", corpus["kind"]).make
    pool, depth = traffic["pool"], traffic.get("in_flight", 1)

    patterns = bench.module("rulesets", config["ruleset"]["kind"]).make(
        config["ruleset"])
    seqs = np.random.SeedSequence(seed % (1 << 64)).spawn(pool + 1)
    batches = []
    for j in range(pool):
        rng = np.random.default_rng(seqs[j])
        gen = torch.Generator(device=device)
        gen.manual_seed(int(rng.integers(1 << 63)))
        batches.append(make_corpus(corpus, patterns, corpus["bytes"], rng,
                                   gen, device))
    _sync(device)
    log(f"set-up: {len(patterns)} patterns, {pool} batches of "
        f"{[b.numel() for b in batches]} bytes, "
        f"{time.time() - t_process:.3f} s")

    t_m = time.time()
    matcher = matcher_factory(patterns, device)
    op = op_mod.Op(matcher, device, depth)
    for j in range(pool):           # every batch once: builds every program
        out = op.call(batches[j])
        op.readback(out, 0)
        _sync(device)
        op.complete(out, 0)
        if j == 0:
            engine_build_s = time.time() - t_m
    # as many outputs alive at once as the window keeps, so that the
    # allocator holds their blocks before the window
    held = [op.call(batches[k % pool]) for k in range(2 * pool + depth)]
    _sync(device)
    del held, out
    gc.collect()
    done = Done(device, depth)
    keep = Keeper(pool, np.random.default_rng(seqs[pool]))
    setup_s = time.time() - t_process
    log(f"handle: engine_build_s {engine_build_s:.3f}; setup_s {setup_s:.3f}")

    win = _window(op, batches, seconds, depth, done, keep, least_bytes)
    log(f"window: {win.completed} requests, {win.failed} failed, "
        f"{win.seconds:.3f} s")
    traced, summary = None, None
    if trace:
        got: list[Window] = []

        def traced_window() -> None:
            _window(op, batches, TRACE_WARMUP_S, depth, done, keep,
                    least_bytes)
            with torch.profiler.record_function(devtrace.WINDOW):
                got.append(_window(
                    op, batches, traffic.get("trace_seconds", DEFAULT_TRACE_S),
                    depth, done, keep, least_bytes))
            _sync(device)

        summary = devtrace.profile(traced_window)
        traced = got[0]
        log(f"traced window: {traced.completed} requests"
            + ("; no device activity recorded" if summary is None else ""))
    _sync(device)
    peak_mem = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else None)
    del op, matcher
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    limits = dict(op_mod.LIMITS, failed_requests=0, batches_unchecked=0)
    checks = dict.fromkeys(limits, 0)
    checks["failed_requests"] = win.failed + (traced.failed if traced else 0)
    t_check = time.time()
    trie = reference.build(patterns)
    for b in range(pool):
        outs = keep.outputs(b)
        if not outs:
            checks["batches_unchecked"] += 1
            continue
        n = batches[b].numel()
        ref = reference.match_dense(trie, batches[b], n)
        for out in outs:
            for k, v in op_mod.compare(out, ref, n).items():
                checks[k] += v
        del ref
    _sync(device)
    log(f"check: {time.time() - t_check:.3f} s")
    return Run(cell=name, setup_s=setup_s,
               engine_build_s=engine_build_s, window=win, traced=traced,
               trace=summary, peak_bytes_per_s=_peak_bandwidth(device),
               memory_peak_bytes=peak_mem, checks=checks, limits=limits)


def result(bench: Bench, run: Run, trace: bool, device_info: dict) -> dict:
    """The result line: the cell's metrics for this mode, the device, the
    breakdown when traced, and last the numbers compared with their
    limits."""
    metrics = {}
    for m in bench.metrics(run.cell, trace):
        value = bench.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(device_info)
    line = {"correct": run.correct,
            "attempted": run.window.completed + run.window.failed,
            "failed": run.window.failed, "metrics": metrics,
            "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = {
            "device_ops": [[k, v] for k, v in run.trace.device_ops],
            "idle_gaps": [[f"host in {k}", v] for k, v in
                          run.trace.idle_gaps]}
    line["checks"] = {k: {"value": v, "limit": run.limits[k]}
                      for k, v in run.checks.items()}
    return line


def _power_limit() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return res.stdout.strip() or f"not read ({res.stderr.strip()})"


def main(argv: list[str], t_process: float | None = None) -> int:
    p = argparse.ArgumentParser(prog="pfac_bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = Bench.load()
    cell = bench.cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"pfac_bench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), device, t_process=t_process)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"pfac_bench: the run loaded {', '.join(loaded)}; the program "
              "under test must not", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": cell["chips"],
            "memory_peak_bytes": run.memory_peak_bytes}
    line = result(bench, run, bool(args.trace), info)
    if args.trace and run.trace is None:
        print("pfac_bench: the profiler recorded no device activity in the "
              "traced window", file=sys.stderr)
        return 4
    print(f"card: {_power_limit()}", file=sys.stderr)
    for e in (run.window.errors + (run.traced.errors if run.traced else
                                   []))[:5]:
        print(f"failed request: {e}", file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0

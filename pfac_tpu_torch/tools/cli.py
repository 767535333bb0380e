"""Command-line tools of the port: match + profile (counterpart of
``pfac_tpu.tools.cli``, with the same flags plus ``--device``).

Usage:
  python -m pfac_tpu_torch.tools.cli match  -P patterns.txt -I corpus.bin [options]
  python -m pfac_tpu_torch.tools.cli profile -P patterns.txt -I corpus.bin [options]

Options:
  -P <file>   pattern file
  -I <file>   input file
  --space     space-driven (hashed) table
  --platform  device|cpu|cpu_parallel
  --device    torch device of Platform.DEVICE (default cuda)
  --tile N    start positions per tile
  --iters N   timed iterations (profile)
  --trace DIR write a torch.profiler trace of one iteration (profile)
  --sharded   shard the input over the mesh of --device (every visible GPU
              for cuda) and match_reduce there; one process enqueues
              every shard, so over several cards this is slower than one
              card (one process a card, dist.multihost, scales)
  --shards N  shards of --sharded (default: one a visible GPU for cuda,
              else 1)
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def _build_matcher(args):
    from ..runtime.handle import Matcher

    return Matcher(
        pattern_file=args.patterns,
        perf_mode="hash" if args.space else "dense",
        platform=args.platform,
        tile=args.tile,
        device=args.device,
    )


def cmd_match(args) -> int:
    if args.sharded:
        from ..core.automaton import Automaton
        from ..dist.sharding import ShardedMatcher, device_mesh

        with open(args.input, "rb") as f:
            data = f.read()
        a = Automaton.from_pattern_file(args.patterns)
        m = ShardedMatcher(a, mesh=device_mesh(args.device, args.shards),
                           perf_mode="hash" if args.space else "dense")
        ids, pos, n = m.match_reduce(data)
    elif args.stream:
        # chunked scan: bounded memory for arbitrarily large inputs
        m = _build_matcher(args)
        sm = m.stream(min_batch=args.stream_chunk)
        ids_parts, pos_parts = [], []

        def collect(start, out):
            hit = np.flatnonzero(out > 0)
            if hit.size:
                ids_parts.append(out[hit])
                pos_parts.append((hit + start).astype(np.int64))

        with open(args.input, "rb") as f:
            while True:
                chunk = f.read(args.stream_chunk)
                if not chunk:
                    break
                collect(*sm.feed(chunk))
        collect(*sm.finish())
        ids = np.concatenate(ids_parts) if ids_parts else np.zeros(0, np.int32)
        pos = np.concatenate(pos_parts) if pos_parts else np.zeros(0, np.int64)
        n = int(ids.shape[0])
    else:
        with open(args.input, "rb") as f:
            data = f.read()
        m = _build_matcher(args)
        ids, pos, n = m.match_reduce(data)
    print(f"num_matched = {n}")
    limit = n if args.all else min(n, args.head)
    for i in range(limit):
        print(f"At position {int(pos[i]):4d}, match pattern {int(ids[i])}")
    if limit < n:
        print(f"... ({n - limit} more; --all to print)")
    return 0


def _device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def cmd_profile(args) -> int:
    with open(args.input, "rb") as f:
        data = f.read()
    n = len(data)
    m = _build_matcher(args)
    eng = m._engine()
    dev = eng.device
    data_dev = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    out = eng.match_device(data_dev)      # build + warm
    sync()

    if args.trace:
        # one traced iteration, as a Chrome trace (chrome://tracing,
        # Perfetto)
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            eng.match_device(data_dev)
            sync()
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace, "trace.json"))

    # median of single calls: CUDA events on the card, the host clock on
    # the CPU (whose calls end when their work does)
    times = []
    for _ in range(max(1, args.iters)):
        if dev.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            eng.match_device(data_dev)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) / 1e3)
        else:
            t0 = time.perf_counter()
            eng.match_device(data_dev)
            times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    if hasattr(eng, "flush_checks"):
        eng.flush_checks()
    n_matched = int((out > 0).sum())

    report = {
        "input_bytes": n,
        "elapsed_ms": round(dt * 1e3, 3),
        "throughput_GBps": round(n / dt / 1e9, 3),
        "throughput_Gbps": round(n * 8 / dt / 1e9, 2),
        "num_matched": n_matched,
        "perf_mode": "space" if args.space else "time",
        "num_states": m.automaton.num_states,
        "device": _device_name(dev),
        "engine": type(eng).__name__,
    }
    print(json.dumps(report, indent=2))
    sys.stdout.write(m.memory_usage())
    if args.histogram:
        hist = m.automaton.match_histogram(out[:n].cpu().numpy())
        for pid, c in sorted(hist.items(), key=lambda kv: -kv[1])[:20]:
            print(f"pattern {pid:6d}: {c} matches")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pfac-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("match", "profile"):
        sp = sub.add_parser(name)
        sp.add_argument("-P", "--patterns", required=True)
        sp.add_argument("-I", "--input", required=True)
        sp.add_argument("-S", "--space", action="store_true")
        sp.add_argument("--platform", default="device",
                        choices=["device", "cpu", "cpu_parallel"])
        sp.add_argument("--device", default="cuda",
                        help="torch device of the device platform")
        sp.add_argument("--tile", type=int, default=None)
        if name == "match":
            sp.add_argument("--head", type=int, default=20)
            sp.add_argument("--all", action="store_true")
            sp.add_argument("--sharded", action="store_true",
                            help="shard the input over the mesh of --device "
                                 "(one process enqueues every shard: over "
                                 "several cards slower than one card)")
            sp.add_argument("--shards", type=int, default=None,
                            help="shards of --sharded (default: one a "
                                 "visible GPU for cuda, else 1)")
            sp.add_argument("--stream", action="store_true",
                            help="chunked scan via StreamMatcher (bounded memory)")
            sp.add_argument("--stream-chunk", type=int, default=16 << 20)
        else:
            sp.add_argument("--iters", type=int, default=5)
            sp.add_argument("--trace", default=None, metavar="DIR",
                            help="write a torch.profiler trace of one iteration")
            sp.add_argument("--histogram", action="store_true",
                            help="print per-pattern match counts")
    args = p.parse_args(argv)
    return cmd_match(args) if args.cmd == "match" else cmd_profile(args)


if __name__ == "__main__":
    raise SystemExit(main())

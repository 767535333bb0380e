"""Scaling of the sharded sieve engine over shard counts: counterpart of
``pfac_tpu.tools.bench_scaling``.

Runs the sharded matcher (``dist/sharding.py``) over meshes of 1, 2, 4,
... shards dealt round robin over the visible GPUs (several shards on one
card where there are fewer cards), and prints one JSON line for the
single-device sieve engine (``SieveMatcher.match_device``), then one a
mesh: bytes, median ms, GB/s, GB/s per distinct card, the efficiency
against the single-device engine, the host's time to enqueue one call
(``host_ms``), the card's name and its power limit. The timed call
is the match without the global count, as in the reference; the count
(one more pass over the result: ``count_kernel`` a shard, summed) is
timed apart (``count_ms``). Times are
CUDA-event medians on one card; over several cards, host-clock medians of
calls that end with every card synchronised.

The input is the port's Snort-like ruleset (``rulesets.snort_like_patterns``)
over a seeded random corpus (or the DEFCON-like text), with parity gates
before any timing: a 256 KB slice against the golden model, single and
sharded, and every mesh's whole result and count against the single
device's.

Run:  python -m pfac_tpu_torch.tools.bench_scaling [--mb 128]
          [--mesh 1,2,4] [--corpus random|defcon_like] [--seed 42]
Without a GPU it exits 1.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

SLICE = 1 << 18


def _time_ms(fn, devices, reps: int = 10) -> float:
    """Median ms of one call: CUDA events on one card; over several, the
    host clock from every card idle to every card done."""
    from ..experiments.gathers import cuda_ms

    distinct = list(dict.fromkeys(devices))
    if len(distinct) == 1:
        with torch.cuda.device(distinct[0]):
            return cuda_ms(fn, reps=reps)
    fn()
    times = []
    for _ in range(reps):
        for d in distinct:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        fn()
        for d in distinct:
            torch.cuda.synchronize(d)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _host_ms(fn, devices, reps: int = 10) -> float:
    """Median host time to enqueue one call, every card idle at its
    start."""
    distinct = list(dict.fromkeys(devices))
    times = []
    for _ in range(reps):
        for d in distinct:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    for d in distinct:
        torch.cuda.synchronize(d)
    return float(np.median(times))


def scaling_lines(automaton, data: np.ndarray, sizes, corpus: str,
                  card: str, engine=None, data_dev=None) -> list[dict]:
    """The single-device line, then one line a mesh size in `sizes`.
    `engine`: a ``SieveMatcher`` on cuda:0 built beforehand, whose tables
    every mesh shares; `data_dev`: `data` already on cuda:0."""
    from ..backends import count as count_mod
    from ..backends import golden
    from ..backends.sieve_matcher import SieveMatcher
    from ..dist.sharding import ShardedMatcher, device_mesh

    n = data.shape[0]
    s = data[:SLICE]
    want = golden.match_edges_batch(automaton, s)
    dev = torch.device("cuda", 0)
    single = engine or SieveMatcher(automaton, device=dev)
    if not np.array_equal(single.match(s), want):
        raise AssertionError("single-device parity failed")
    dd = torch.from_numpy(data).to(dev) if data_dev is None else data_dev
    whole = single.match_device(dd)[:n]
    t_single = _time_ms(lambda: single.match_device(dd), [dev])
    base = n / t_single / 1e6
    lines = [{"harness": "scaling", "corpus": corpus, "mesh": 0,
              "engine": "single", "bytes": n, "ms": t_single, "GBps": base,
              "GBps_per_chip": base, "efficiency": 1.0,
              "host_ms": _host_ms(lambda: single.match_device(dd), [dev]),
              "card": card}]
    for nd in sizes:
        mesh = device_mesh("cuda", nd)
        sm = ShardedMatcher(automaton, mesh=mesh, engine=single)
        if not np.array_equal(sm.match(s), want):
            raise AssertionError(f"sharded parity failed at {nd} shards")
        shards = sm._put(dd, sm._shard_len(n))
        results, count = sm.match_device(shards, n)
        if not (torch.equal(torch.cat([r.to(dev) for r in results])[:n],
                            whole) and int(count) == int((whole > 0).sum())):
            raise AssertionError(f"{nd} shards != the single device")
        del results
        t = _time_ms(lambda: sm._run(shards, n), mesh.devices)
        host_ms = _host_ms(lambda: sm._run(shards, n), mesh.devices)
        results, _ = sm._run(shards, n)
        t_count = _time_ms(lambda: sm._count(
            [count_mod.count_nonzero(r) for r in results]), mesh.devices)
        chips = len(set(mesh.devices))
        gbps = n / t / 1e6
        lines.append({"harness": "scaling", "corpus": corpus, "mesh": nd,
                      "engine": "sieve", "bytes": n, "ms": t, "GBps": gbps,
                      "GBps_per_chip": gbps / chips,
                      "efficiency": gbps / chips / base, "chips": chips,
                      "host_ms": host_ms, "count_ms": t_count, "card": card})
        del sm, shards, results
        torch.cuda.empty_cache()
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=128, help="corpus MB (global)")
    ap.add_argument("--mesh", type=str, default="",
                    help="comma-separated shard counts (default: 1, 2, 4 "
                         "and one a visible GPU)")
    ap.add_argument("--corpus", choices=("random", "defcon_like"),
                    default="random")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_scaling: no GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from ..core.automaton import Automaton
    from ..experiments import harness, rulesets

    ndev = torch.cuda.device_count()
    sizes = ([int(x) for x in args.mesh.split(",") if x] if args.mesh
             else sorted({1, 2, 4, ndev}))
    pats = rulesets.snort_like_patterns()
    a = Automaton.from_patterns(pats)
    rng = np.random.default_rng(args.seed)
    n = args.mb << 20
    data = (rng.integers(0, 256, size=n, dtype=np.uint8)
            if args.corpus == "random"
            else rulesets.planted_text(rng, pats, n, 0.015))
    for line in scaling_lines(a, data, sizes, f"{args.corpus}_{args.mb}MB",
                              harness.card()):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

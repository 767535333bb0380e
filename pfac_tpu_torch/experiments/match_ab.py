"""Same-card A/B of ``match_device`` between checkouts of the repository.

    python -m pfac_tpu_torch.experiments.match_ab DIR_A DIR_B [DIR ...]

Each argument is the root of a checkout (this one is ``.``). The script runs
one worker process per argument, in the order given, so a call such as
``parent . . parent`` times the two trees in turns on one card. A worker
imports ``pfac_tpu_torch`` from its checkout, builds its kernels there,
makes the six corpora of ``chip_smoke.py`` from their seeds (with this
checkout's ``rulesets.py``, loaded by path, so every tree sees the same
bytes), and prints per corpus one JSON line: the CUDA-event median of a warm
``Matcher(device="cuda").match_device`` call (10 calls after 2 warm-up
calls), GB/s, a fingerprint of the result, the torch.profiler device time
per kernel over 5 calls, and the card's clocks, power and temperature
right after (nvidia-smi). It uses only the API every slice of the port
has (``Matcher``, ``match_device``, ``_engine().tile_rows``). Without CUDA
it exits 1.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MB = 1 << 20


def _rulesets():
    spec = importlib.util.spec_from_file_location(
        "_ab_rulesets", os.path.join(HERE, "rulesets.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import numpy as np
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _kernels(fn, reps: int = 5) -> dict[str, float]:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: round(e.self_device_time_total / reps / 1e3, 4)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def _clocks() -> str:
    """SM clock, its maximum, power draw and temperature (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60, check=True).stdout.strip()


def worker(tree: str) -> int:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    import pfac_tpu_torch as pt

    if not torch.cuda.is_available():
        print("no GPU (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    assert os.path.abspath(pt.__file__).startswith(os.path.abspath(tree))
    rs = _rulesets()
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    pats = rs.snort_like_patterns()
    m = pt.Matcher(pats, device=dev)
    rng = np.random.default_rng(42)
    rand = rng.integers(0, 256, size=128 * MB, dtype=np.uint8)
    defcon = rs.planted_text(rng, pats, 128 * MB, 0.015)
    brng = np.random.default_rng(7)
    bpats = rs.clamav_like_patterns(brng)
    mb = pt.Matcher(bpats, device=dev)
    big = rs.planted_text(brng, bpats, 128 * MB, 0.002)
    m1 = pt.Matcher([b"aaaa"], device=dev)
    mpats = pats + [b"zzzz", b"zzzzzzzz"]
    mm = pt.Matcher(mpats, device=dev)
    block = mm._engine().tile_rows * 128
    mixed = rs.mixed_density(np.random.default_rng(3), mpats, 16 * MB, block)
    corpora = [("random", m, rand), ("defcon_like", m, defcon),
               ("big_ruleset", mb, big),
               ("all_match", m1, np.full(100 * MB, ord("a"), np.uint8)),
               ("no_match", m1, np.full(100 * MB, ord("b"), np.uint8)),
               ("mixed", mm, mixed)]
    print(f"worker {tree}: set-up {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, mt, host in corpora:
        d = torch.from_numpy(host).to(dev)
        res = mt.match_device(d)
        ids = res[: host.shape[0]].to(torch.int64)
        pos = torch.arange(ids.numel(), device=dev, dtype=torch.int64)
        fingerprint = [int((ids > 0).sum()), int((ids * (pos % 65521)).sum())]
        ms = _ms(lambda: mt.match_device(d))
        kernels = _kernels(lambda: mt.match_device(d))
        print(json.dumps({"tree": tree, "corpus": name, "ms": ms,
                          "GB/s": host.shape[0] / ms / 1e6,
                          "fingerprint": fingerprint, "device_ms": kernels,
                          "clocks": _clocks()}), flush=True)
        del d, res, ids, pos
        torch.cuda.empty_cache()
    return 0


def main(argv: list[str]) -> int:
    if len(argv) >= 2 and argv[0] == "--worker":
        return worker(argv[1])
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--worker", tree]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

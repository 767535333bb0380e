"""Multi-process smoke run of the match path: counterpart of the
reference's ``experiments/multihost_smoke.py``.

One process a visible GPU (``--nproc``), process i with two shards on
GPU i, joins one NCCL process group through a ``file://`` store in a
temporary directory (no port to share with other jobs); on a host with
one GPU that is a group of one rank. With no GPU it exits 1. ``--cpu``
runs two processes (``--nproc``), each with two CPU shards, over gloo
instead. Each feeds only its own slice of a seeded input
(``multihost.host_shard_slice`` and ``put_host_shards``), runs
``ShardedMatcher.match_device`` with both engines, and checks its own
shards against the golden model, with a pattern planted across every
shard boundary, the boundary between the two processes among them, and
the global count.

Run:  python -m pfac_tpu_torch.experiments.multihost_smoke [--cpu]
          [--nproc N] [--timeout S]   (spawns the processes; exit 0 when
      all pass)
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
LOCAL_SHARDS = 2


def worker(proc_id: int, nproc: int, store: str, cpu: bool) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..backends import golden
    from ..core import Automaton
    from ..dist import multihost
    from ..dist.sharding import ShardedMatcher

    torch.set_num_threads(2)
    devices = ["cpu" if cpu else f"cuda:{proc_id}"] * LOCAL_SHARDS
    if not cpu:
        torch.cuda.set_device(proc_id)
    multihost.initialize(f"file://{store}", nproc, proc_id, devices)
    try:
        mesh = multihost.global_mesh(devices)
        assert (mesh.world, mesh.size) == (nproc, nproc * LOCAL_SHARDS)
        a = Automaton.from_patterns([b"q", b"qw", b"qwe", b"qwert", b"hello"])
        rng = np.random.default_rng(11)          # every process: same bytes
        n = (2 * nproc - 1) * (1 << 16) + 77
        buf = rng.integers(97, 123, size=n, dtype=np.uint8)
        buf[:5] = np.frombuffer(b"hello", np.uint8)
        for engine in ("xla", "sieve"):
            sm = ShardedMatcher(a, mesh=mesh, tile=256, engine=engine)
            sl = sm._shard_len(n)
            data = buf.copy()
            for b in range(sl, n - 6, sl):        # straddle every boundary
                data[b - 2:b + 3] = np.frombuffer(b"qwert", np.uint8)
            want = golden.match_dense(a, data)
            total = sl * mesh.size
            padded = np.zeros(total, dtype=np.uint8)
            padded[:n] = data
            start, stop = multihost.host_shard_slice(total, sl, mesh)
            shards = multihost.put_host_shards(sm, padded[start:stop], total)
            results, count = sm.match_device(shards, n)
            assert int(count) == int((want > 0).sum()), (engine, int(count))
            for i, r in enumerate(results):
                lo = mesh.global_index(i) * sl
                hi = min(lo + sl, n)
                got = r.cpu().numpy()
                assert np.array_equal(got[:max(hi - lo, 0)], want[lo:hi]), \
                    f"process {proc_id} {engine}: shard at {lo} differs"
                assert not got[max(hi - lo, 0):].any()
            print(f"[process {proc_id}] {engine} ok on {devices[0]} "
                  f"({dist.get_backend()}): count={int(count)}, "
                  f"shards {mesh.global_index(0)}-"
                  f"{mesh.global_index(LOCAL_SHARDS - 1)} of {mesh.size}, "
                  f"shard_len {sl}", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--proc", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--nproc", type=int, default=None,
                    help="processes (default: one a visible GPU; 2 with "
                         "--cpu)")
    ap.add_argument("--cpu", action="store_true",
                    help="CPU shards over gloo instead of one GPU a process "
                         "over NCCL")
    ap.add_argument("--timeout", type=float, default=240.0,
                    help="seconds before every process is killed")
    args = ap.parse_args(argv)
    if args.proc is not None:
        worker(args.proc, args.nproc, args.store, args.cpu)
        return 0
    if args.cpu:
        nproc = args.nproc or 2
    else:
        import torch

        if not torch.cuda.is_available():
            print("multihost_smoke: no GPU is visible (--cpu runs gloo "
                  "processes on the CPU)", file=sys.stderr)
            return 1
        nproc = args.nproc or torch.cuda.device_count()
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "pfac_tpu_torch.experiments.multihost_smoke",
             "--proc", str(i), "--nproc", str(nproc), "--store", store]
            + (["--cpu"] if args.cpu else []),
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for i in range(nproc)]
        rc = 0
        try:
            for i, p in enumerate(procs):
                out, _ = p.communicate(timeout=args.timeout)
                tail = "\n".join(out.decode(errors="replace")
                                 .strip().splitlines()[-6:])
                print(f"--- process {i} (rc={p.returncode}) ---\n{tail}")
                rc |= p.returncode != 0
        except subprocess.TimeoutExpired:
            print(f"timed out after {args.timeout} s")
            rc = 1
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    print("MULTIHOST SMOKE:", "PASS" if rc == 0 else "FAIL")
    return rc


if __name__ == "__main__":
    sys.exit(main())

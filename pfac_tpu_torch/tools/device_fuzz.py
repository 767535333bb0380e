"""On-device randomized differential fuzz of the port: its compiled
engines against its golden model (counterpart of
``pfac_tpu.tools.device_fuzz``).

The CPU tests run the kernels' plain versions; this tool drives the
compiled kernels on the card across randomized rulesets and corpora, with
the reference's case generator: plain cases, virus-dense (``heavy``) cases
whose survivors walk deep, ``wide`` cases with more than 32,767 pattern IDs
(the CSR tier) and ``allmatch`` cases where nearly every position survives
(the dense-block escape, K3). Each case compares ``match_device`` and
``match_reduce_device`` (and, on some small plain cases, the lockstep
walker's ``match_reduce_device``) with ``golden.match_edges_batch``; with
``--sharded`` also ``ShardedMatcher.match`` and ``match_reduce`` on the
mesh of ``--device`` (``--shards`` shards; default one a visible GPU for
``cuda``, else 1).

Usage:  python -m pfac_tpu_torch.tools.device_fuzz [--cases N] [--seed S]
            [--kind plain|heavy|wide|allmatch] [--max-seconds T] [--device D]
            [--sharded [--shards K]]
Exits non-zero on the first mismatch, printing a reproducer. The
reference's ``--windows-bitcast`` (a TPU workaround) is left out.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

KINDS = ("plain", "heavy", "wide", "allmatch")


def _random_case(rng: np.random.Generator, heavy: bool = False,
                 wide: bool = False, allmatch: bool = False):
    if allmatch:
        # dense-block escape coverage (block_walk.DENSE_ESCAPE_DIV):
        # nearly every position survives, so whole blocks take K3's walk,
        # block-boundary straddles included
        ch = int(rng.integers(97, 123))
        deep = int(rng.integers(5, 60))
        pats = [bytes([ch]) * 4, bytes([ch]) * deep,
                bytes([ch, ch, 123, 124])]
        n = int(rng.integers(1_500_000, 2_500_000))
        data = bytearray(bytes([ch]) * n)
        for _ in range(30):                    # breaks + near-end edges
            off = int(rng.integers(0, n))
            data[off] = int(rng.integers(0, 97))
        return pats, bytes(data)
    alpha = int(rng.integers(2, 257))
    k = int(rng.integers(1, 200))
    pats, seen = [], set()
    for _ in range(k):
        # heavy cases use the Snort length range (1-243): deep walker
        # steps run compiled here, not only in the CPU tests
        ln = (int(np.clip(rng.gamma(2.2, 9.0) + 4, 4, 243)) if heavy
              else int(np.clip(rng.gamma(1.8, 4.0) + 1, 1, 64)))
        p = bytes(rng.integers(0, alpha, size=ln).astype(np.uint8))
        if p not in seen:
            seen.add(p)
            pats.append(p)
    if wide:
        # > 32767 pattern IDs: wide m2/m3 encodings and the CSR tier on
        # the compiled path
        keys = rng.choice(1 << 16, size=33000, replace=False)
        wpats = [bytes([kk >> 8, kk & 0xFF]) for kk in keys]
        pats = wpats + [p for p in pats if len(p) >= 4][:50]
        n = int(rng.integers(100_000, 400_000))
        data = bytearray(rng.integers(0, 256, size=n)
                         .astype(np.uint8).tobytes())
        for _ in range(40):
            p = pats[int(rng.integers(0, len(pats)))]
            off = int(rng.integers(0, n - len(p) + 1))
            data[off:off + len(p)] = p
        return pats, bytes(data)
    if heavy:
        # virus-dense: the corpus is mostly pattern content, with hundreds
        # of thousands of survivors
        n = int(rng.integers(1_500_000, 3_000_000))
        chunks, sz = [], 0
        while sz < n:
            p = pats[int(rng.integers(0, len(pats)))]
            chunks.append(p)
            sz += len(p)
        return pats, b"".join(chunks)[:n]
    n = int(rng.integers(1, 400_000))
    data = bytearray(rng.integers(0, alpha, size=n).astype(np.uint8).tobytes())
    # plant pattern occurrences, including at the very end
    for _ in range(min(20, n)):
        p = pats[int(rng.integers(0, len(pats)))]
        if len(p) <= n:
            off = int(rng.integers(0, n - len(p) + 1))
            data[off:off + len(p)] = p
    p = pats[0]
    if len(p) <= n:
        data[n - len(p):] = p
    return pats, bytes(data)


def _kind(case: int, args) -> str:
    """The case's kind: --kind for every case, else the reference's
    schedule (every 5th heavy, every 7th wide, every 9th all-match)."""
    if args.kind is not None:
        return args.kind
    if args.heavy or case % 5 == 4:
        return "heavy"
    if case % 7 == 3:
        return "wide"
    if case % 9 == 5:
        return "allmatch"
    return "plain"


def _equal_reduce(rd, gi, gp, gc: int, npad: int) -> bool:
    ids, pos, cnt = (x.cpu() for x in rd)
    c = int(cnt)
    return (c == gc and ids.shape[0] == pos.shape[0] == npad
            and np.array_equal(pos[:c].numpy(), gp)
            and np.array_equal(ids[:c].numpy(), gi)
            and not ids[c:].any() and not pos[c:].any())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sharded", action="store_true",
                    help="also the sharded matcher on the mesh of --device")
    ap.add_argument("--shards", type=int, default=None,
                    help="shards of --sharded (default: one a visible GPU "
                         "for cuda, else 1)")
    ap.add_argument("--heavy", action="store_true",
                    help="ALL cases virus-dense (default: every 5th case)")
    ap.add_argument("--kind", choices=KINDS, default=None,
                    help="every case of this kind (default: the schedule)")
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="start no case after this many seconds")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("device_fuzz: no GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1

    from ..backends import golden
    from ..backends.sieve_matcher import SieveMatcher
    from ..backends.xla import XlaMatcher
    from ..core.automaton import Automaton
    from ..dist.sharding import ShardedMatcher, device_mesh
    from ..runtime.handle import Matcher

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}")
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for case in range(args.cases):
        if (args.max_seconds is not None
                and time.perf_counter() - t0 > args.max_seconds):
            print(f"time cap of {args.max_seconds} s: {case} cases run")
            break
        kind = _kind(case, args)
        pats, data = _random_case(rng, heavy=kind == "heavy",
                                  wide=kind == "wide",
                                  allmatch=kind == "allmatch")
        a = Automaton.from_patterns(pats)
        m = Matcher(automaton=a, device=dev)
        n = len(data)
        d = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
        exp = golden.match_edges_batch(a, data)
        out = m.match_device(d)
        got = out[:n].cpu().numpy()
        again = ("python -m pfac_tpu_torch.tools.device_fuzz --seed "
                 f"{args.seed} --cases {case + 1}"
                 + (f" --kind {args.kind}" if args.kind else "")
                 + (" --heavy" if args.heavy else "")
                 + f" --device {args.device}"
                 + (" --sharded" if args.sharded else "")
                 + (f" --shards {args.shards}" if args.shards else ""))
        if not np.array_equal(got, exp) or out[n:].any():
            bad = np.nonzero(got != exp)[0][:5]
            print(f"MISMATCH case={case} kind={kind} seed={args.seed} "
                  f"k={len(pats)} n={n} at {bad.tolist()}; reproduce: "
                  f"{again}")
            for b in bad:
                print(f"  pos {b}: got {got[b]} expected {exp[b]}")
            return 1
        gi, gp, gc = golden.reduce_result(exp)
        engines = [m._engine()]
        if kind == "plain" and n < 500_000 and case % 4 == 2:
            engines.append(XlaMatcher(a, perf_mode="dense", device=dev))
        for eng in engines:
            rd = eng.match_reduce_device(d)
            if not _equal_reduce(rd, gi, gp, gc, rd[0].shape[0]):
                print(f"REDUCE-DEVICE MISMATCH case={case} kind={kind} "
                      f"engine={type(eng).__name__} seed={args.seed} "
                      f"count={int(rd[2])} expected={gc}; reproduce: {again}")
                return 1
        if args.sharded:
            mesh = device_mesh(args.device, args.shards)
            eng = m._engine()       # its tables, not built again
            sm = ShardedMatcher(a, mesh=mesh, engine=(
                eng if isinstance(eng, SieveMatcher)
                and mesh.devices[0].type == "cuda" else "auto"))
            ids, pos, cnt = sm.match_reduce(data)
            if not (np.array_equal(sm.match(data), exp) and cnt == gc
                    and np.array_equal(pos, gp) and np.array_equal(ids, gi)):
                print(f"SHARDED MISMATCH case={case} kind={kind} "
                      f"engine={sm.engine} shards={sm.num_devices} "
                      f"seed={args.seed}; reproduce: {again}")
                return 1
        print(f"case {case:3d}: ok {kind}  "
              f"engine={type(m._engine()).__name__} "
              f"k={len(pats)} n={n} matches={gc}", flush=True)
    print("all cases passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch/CUDA port (pfac_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, ``Matcher(device="cuda").match_device``, on
both device tiers at full size:

* walk-table tier (K1 sieve with its tables in shared memory, K3 dense-block
  escape, survivor compaction, K2 survivor walk): 2,000 Snort-like patterns
  (``rulesets.snort_like_patterns``) over a 128 MB random corpus, a 128 MB
  DEFCON-like corpus (text with 1.5% planted pattern bytes) and a 16 MB
  mixed-density corpus (one dense block in 16); the pattern ``aaaa`` over
  100 MB of ``a`` (every block dense) and 100 MB of ``b`` (no match), the
  reference's Benchmark I corpora;
* CSR tier (K1 with its residuals split across a 2-CTA cluster, compaction,
  CSR walk): 100,000 ClamAV-scale signatures over 128 MB of printable text
  with 0.2% planted signature bytes.

Phases, each on lines of its own:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the kernels from pfac_tpu_torch/csrc and print the build time;
3. conformance example on the card (match and match_reduce);
4. set-up of both rulesets and all corpora (seconds, table sizes);
5. every kernel against its plain torch version on the card, bit-equal:
   K1 in each of its three table placements (the Snort arena in shared
   memory on a 16 MB random slice; the 100K arena across a cluster and
   through L1/L2 on a 16 MB slice of its corpus), the compaction on the
   DEFCON-like, big-ruleset and mixed corpora, K2 on the DEFCON-like
   survivors and the CSR walk on the big corpus's survivors (each with the
   compaction's buffer and device count, a buffer longer than its count, a
   count of 0 and an unaligned data view), K3 on the all-match and mixed
   corpora and five more cases;
6. the main path on every corpus, launch counts reset just before it, under
   torch.profiler: no ``aten::nonzero`` ran; K1 and both compaction kernels
   launched on every corpus, the tier's walker and K3 once a call; then the
   same calls under ``torch.cuda.set_sync_debug_mode("error")``, where any
   host synchronisation raises; each result equal in full to the port's
   plain pipeline on the card, and to the port's numpy golden oracle
   (golden.match_edges_batch) on >= 16 MB of each corpus (>= 4 MB of the
   big-ruleset and F1 corpora); the escape taken on the all-match, mixed and
   F1 corpora. The seventh corpus, f1_entry_tables, is ROADMAP.md's F1: a
   ruleset whose entry tables outgrow the walk kernels' shared memory, so
   they read every table through L1/L2;
7. every kernel of the path launched;
8. CUDA-event times (median after warm-up; a kernel over batches of 10
   calls, match_device one call at a time) of each kernel, its plain
   version, its library yardstick where one PyTorch call computes the same
   function (``torch.nonzero`` over uint8 flags for the compaction), and
   its bound; the compaction's two kernels by torch.profiler; the 100K
   arena's two placements in turns; K2 on the DEFCON-like, random and
   mixed survivors and the CSR walk on the big corpus's (batched and by
   torch.profiler, with the grid and the arena bytes resident in shared
   memory, and on the one survivor whose match is longest alone: the
   chain floor), K2 with less of its arena resident; K3 on the all-match, mixed and random corpora (batched and by
   torch.profiler, with its bound, the arena words resident in shared
   memory and the tiles walked); match_device end to end on every corpus
   with the device's busy share of it, and the all-match corpus with the
   escape disarmed; torch.profiler breakdowns (a kernel's profiler time is
   the median over the launches the profiler recorded; it may record fewer
   than were made); the card's clocks before and after;
9. the table-probe micro-benchmarks (``pfac_tpu_torch.experiments``, the
   counterparts of the reference's E1-E6) at full size, and G1/G3 over the
   four arenas built above, launch counts reset just before them: every
   case bit-equal to its plain version and to the reference case's numpy
   expectation, every placement that must refuse its table refused, each
   of the kernels G1-G4 launched (G1's two, one CTA's table and a
   cluster's; G2's two, staged and direct); G1 runs in each of its
   placements (smem, cluster, ldg, cg) wherever the table fits and in the
   one it takes by default; then a ``time`` line per case (with
   ``torch.take`` / ``torch.gather`` beside G1 / G2; E5's shapes also on
   the path the rule did not pick), and for the launch-bound G2 cases the
   card's own time of the kernel and of ``torch.gather``'s
   (torch.profiler), and the same for G1 on E1 C/D, E2 and the E6 planes
   (beside ``torch.take``'s) and for G4 on E4;
10. the lockstep walker (``backends/xla.py``): every tier that takes it
   (``Backend.XLA`` dense and hash, ``PlacementMode.HBM``, and the fallback
   from a sieve-table budget patched to 0 in this process; ``Backend.PALLAS``
   over that budget raises) over the Snort set on 16 MB of the random and
   DEFCON-like corpora, and the 100K ruleset in dense mode on 4 MB of its
   corpus (its hash tables are refused, as in the reference), each equal to
   the sieve engine on the same bytes and to the golden model, with e2e
   times and table bytes; the device reduce (``match_reduce_device``) on
   every corpus of phase 6, launch counts reset just before it, under
   ``torch.cuda.set_sync_debug_mode("error")``: reduce_kernel and
   reduce_tail_kernel launched once a corpus, each result equal to the
   plain reduce, its times (and each kernel's by the profiler) against its
   bound (12 B a position) and ``torch.nonzero(result > 0)``; the C-style
   API's ``PFAC_matchFromDevice`` / ``PFAC_matchFromDeviceReduce`` on CUDA
   tensors; ``tools/device_fuzz`` on two cases of each kind under a time
   cap;
11. the sharded matcher (``dist/sharding.py``): the sieve engine on 2 and
   4 shards of the card over the random, DEFCON-like, big-ruleset and
   all-match corpora, launch counts reset just before each call (every
   kernel of the tier once a shard), equal in full to the single device
   (results, count, match_reduce with int64 positions) and under
   ``torch.cuda.set_sync_debug_mode("error")``; the longest pattern
   planted across every shard boundary against the golden model; a
   process group of one rank (NCCL) with 2 local shards; the walker engine
   sharded; ``tools/bench_scaling``'s lines for 1, 2 and 4 shards on the
   random and DEFCON-like corpora with the card's busy time a call; and
   ``device_fuzz --sharded``;
12. the system's own entry points: ``tools/bench`` (its gates, among them
   the fingerprint of the whole 128 MB result against
   ``golden.match_dense_batch`` and its first 4 MB exactly, then its
   timing; the line prefixed ``bench:``); ``tools/bench_matrix``'s seven
   regimes (every gate first, then one line a regime prefixed
   ``regime:``); on ``virus_dense_worst`` (8 MB of concatenated Snort-like
   patterns, 396,847 survivors, no block dense enough to escape) the main
   path's launches counted (K1, both compaction kernels, K2 and K3 once;
   K3 walks no block), no ``aten::nonzero``, the call again under
   ``torch.cuda.set_sync_debug_mode("error")``, K2's time on its
   survivors as in phase 8 and on the first one and two survivors a lane
   of its grid, and the e2e with the card's busy share; the survivor counts of the DEFCON-like and
   virus-dense corpora against the reference's records; the reduce on
   ``reduce_device_3pct``'s vector timed as in phase 10; then
   ``tools/graft_entry``'s walker step (equal to the CPU's) and
   ``dryrun_multichip(4)`` on the card.

Then one JSON line of per-kernel results (every kernel of the main path,
reduce_kernel and reduce_tail_kernel with their launches on the reduce
path, and G1-G4, each with its bound and library time), and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result; so does a machine without a GPU.
Integer IDs and positions are compared exactly (tolerance 0). A bound is
the bytes the function must move (each input read once, each output
written once, as this run's data needs them) over the H100's 3.35 TB/s.
"""
from __future__ import annotations

import itertools
import json
import sys
import time

import numpy as np
import torch

MB = 1 << 20
CORPUS = 128 * MB
BENCH1 = 100 * MB          # Benchmark I corpora
MIXED = 16 * MB
F1_BYTES = 4 * MB          # the F1 corpus
SLICE = 16 * MB
BIG_SLICE = 4 * MB         # golden slice of the big-ruleset corpus
GOLDEN_SECONDS = 20.0      # per corpus: widen the golden check while time allows
HBM = 3.35e12              # H100 SXM device memory, bytes/s (data sheet)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM * 1e3


def profiled(fn, reps: int, need: tuple = ()):
    """`reps` calls of fn under torch.profiler -> ([(device ms of a launch,
    launches recorded, kernel name)], host wall ms per call), the
    device-side events only (kernels, copies: a CPU op's device time
    repeats the time of the kernels it launched). The profiler's sums are
    not to be divided by the calls made: it may record fewer launches than
    were made, or more events than launches, and now and then none of a
    window (seen on a process's first CUDA window). So a kernel's time is
    the median over the events recorded with a duration, and the window is
    repeated, at most four times, until it shows device time and every
    kernel named in `need`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        spans: dict[str, list[float]] = {}
        for e in prof.events():
            if (e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0):
                spans.setdefault(e.key, []).append(e.self_device_time_total)
        rows = sorted(((float(np.median(v)) / 1e3, len(v), key)
                       for key, v in spans.items()), reverse=True)
        if rows and all(any(is_kernel(key, k) for _, _, key in rows)
                        for k in need):
            break
    return rows, wall_ms


def is_kernel(key: str, kernel: str) -> bool:
    """Whether the profiler row `key` is the kernel named `kernel`
    (a plain function or a template's instance)."""
    return f"{kernel}(" in key or f"{kernel}<" in key


def device_ms(fn, reps: int = 10, need: tuple = ()) -> dict[str, float]:
    """torch.profiler device time of a launch of each kernel fn launches
    (the median over the launches it recorded)."""
    return {key: t for t, _, key in profiled(fn, reps, need)[0]}


def kernel_ms(times: dict[str, float], kernel: str,
              wrapper_ms: float) -> float:
    """The device time of the kernel named `kernel` in device_ms's dict.
    Where the profiler recorded none of its launches in any window, the
    CUDA-event time of the wrapper call that launches it stands in, and a
    line says so."""
    hits = [t for k, t in times.items() if is_kernel(k, kernel)]
    if len(hits) > 1:
        raise AssertionError(f"{kernel}: several profiler rows in {times}")
    if not hits:
        print(f"profiler: no launch of {kernel} recorded; its wrapper's "
              f"CUDA-event time {wrapper_ms:.4f} ms stands in")
        return wrapper_ms
    return hits[0]


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} != {b.shape}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def golden_check(automaton, host: np.ndarray, result: torch.Tensor,
                 name: str, step: int = SLICE,
                 seconds: float = GOLDEN_SECONDS) -> None:
    """Golden oracle on successive `step`-byte slices (each with its
    lookahead) while the time budget lasts; at least one slice."""
    from pfac_tpu_torch.backends import golden

    res = result[: host.shape[0]].cpu().numpy()
    look = automaton.max_pattern_len
    t0 = time.perf_counter()
    off = 0
    while off < host.shape[0]:
        end = min(off + step, host.shape[0])
        want = golden.match_edges_batch(automaton, host[off:end + look])
        if not np.array_equal(res[off:end], want[: end - off]):
            bad = off + int(np.nonzero(res[off:end] != want[: end - off])[0][0])
            raise AssertionError(f"{name}: port != golden at position {bad}")
        off = end
        if time.perf_counter() - t0 > seconds:
            break
    dt = time.perf_counter() - t0
    print(f"golden {name}: {off / MB:.0f} MB equal to match_edges_batch "
          f"({dt:.1f} s, {off / MB / dt:.2f} MB/s on the host)")


def lockstep_phase(dev, name_limit, a, m, snort, big) -> None:
    """Phase 10a: the lockstep walker (``backends/xla.py``) on the card.
    Every tier that takes it (Backend.XLA dense and hash,
    PlacementMode.HBM, and the fallback from a sieve-table budget patched
    to 0) over the Snort set on SLICE bytes of each of `snort`'s corpora,
    and the 100K ruleset on BIG_SLICE bytes of its corpus (`big`: automaton,
    sieve engine's Matcher, device corpus, host corpus); each result equal
    to the sieve engine's on the same bytes and to the golden model, with
    its e2e time and table bytes."""
    import pfac_tpu_torch as pt
    from pfac_tpu_torch.backends import sieve_matcher
    from pfac_tpu_torch.backends.xla import XlaMatcher
    from pfac_tpu_torch.experiments.gathers import cuda_ms

    tiers = {"Backend.XLA dense": dict(backend="xla"),
             "Backend.XLA hash": dict(backend="xla", perf_mode="hash"),
             "PlacementMode.HBM": dict(placement="hbm")}
    walkers = {k: pt.Matcher(automaton=a, device=dev, **kw)
               for k, kw in tiers.items()}
    budget = sieve_matcher._VMEM_TABLE_BUDGET
    sieve_matcher._VMEM_TABLE_BUDGET = 0      # every sieve table is over it
    try:
        fb = pt.Matcher(automaton=a, device=dev)
        walkers["sieve tables over budget (AUTO)"] = fb
        fb._engine()
        try:
            pt.Matcher(automaton=a, device=dev, backend="pallas")._engine()
            raise AssertionError("Backend.PALLAS over budget did not raise")
        except pt.PfacError as e:
            print(f"walker: Backend.PALLAS over budget raises ({e})")
    finally:
        sieve_matcher._VMEM_TABLE_BUDGET = budget
    for tier, mt in walkers.items():
        e = mt._engine()
        assert isinstance(e, XlaMatcher), (tier, type(e))
        print(f"walker {tier}: XlaMatcher, perf_mode {e.perf_mode}, tile "
              f"{e.tile}, {e.table_bytes} bytes of tables on the card")
    for cname, d, host in snort:
        sl, hs = d[:SLICE], host[:SLICE]
        want = m.match_device(sl)
        for tier, mt in walkers.items():
            got = mt.match_device(sl)
            assert got.shape[0] == SLICE and torch.equal(got, want[:SLICE]), \
                f"walker {tier} != sieve engine on {cname}"
            ms = cuda_ms(lambda: mt.match_device(sl), reps=5, warmup=1)
            print(f"time walker {tier} {cname} {SLICE // MB} MB: {ms:.4f} "
                  f"ms = {SLICE / ms / 1e6:.3f} GB/s, equal to the sieve "
                  f"engine ({int((got > 0).sum())} matching positions)  "
                  f"[{name_limit}]")
        golden_check(a, hs, want, f"walker {cname}", SLICE, 0.0)
    ab, mb, big_d, big_host = big
    try:
        pt.Matcher(automaton=ab, device=dev, backend="xla",
                   perf_mode="hash")._engine()
        raise AssertionError("100K hash tables built")
    except pt.PfacError as e:
        print(f"walker 100K hash mode: refused as in the reference ({e})")
    t0 = time.perf_counter()
    mx = pt.Matcher(automaton=ab, device=dev, backend="xla")
    e = mx._engine()
    print(f"walker 100K dense: {e.table_bytes} bytes of tables on the card; "
          f"set-up {time.perf_counter() - t0:.1f} s")
    sl, hs = big_d[:BIG_SLICE], big_host[:BIG_SLICE]
    want = mb.match_device(sl)
    got = mx.match_device(sl)
    assert torch.equal(got[:BIG_SLICE], want[:BIG_SLICE]), \
        "walker 100K != sieve engine"
    ms = cuda_ms(lambda: mx.match_device(sl), reps=5, warmup=1)
    print(f"time walker Backend.XLA dense big_ruleset {BIG_SLICE // MB} MB: "
          f"{ms:.4f} ms = {BIG_SLICE / ms / 1e6:.3f} GB/s, equal to the sieve "
          f"engine  [{name_limit}]")
    golden_check(ab, hs, got, "walker big_ruleset", BIG_SLICE, 0.0)
    del mx, e, got, want, walkers
    torch.cuda.empty_cache()


def time_reduce(nm: str, res: torch.Tensor, c: int, name_limit: str):
    """The device reduce on the result `res` with `c` matches: batched,
    each kernel by the profiler, torch.nonzero(res > 0) and the plain
    version; prints one line -> (batched, reduce_kernel, reduce_tail_kernel,
    torch.nonzero, plain) ms."""
    from pfac_tpu_torch.backends import reduce
    from pfac_tpu_torch.experiments.gathers import cuda_ms
    from pfac_tpu_torch.experiments.harness import BATCH

    npad = res.shape[0]
    run = lambda: reduce.reduce_from_dense(res)
    ms = cuda_ms(run, batch=BATCH)
    times = device_ms(run, need=tuple(reduce.LAUNCHES))
    main_dev = kernel_ms(times, "reduce_kernel", ms)
    tail_dev = kernel_ms(times, "reduce_tail_kernel", ms)
    nonzero_ms = cuda_ms(lambda: torch.nonzero(res > 0), batch=BATCH)
    plain_ms = cuda_ms(lambda: reduce.reduce_plain(res), reps=3, warmup=1)
    bound = bound_ms(reduce.bound_bytes(npad))
    print(f"time reduce {nm} ({npad} positions, {c} matches): "
          f"{ms:.4f} ms batched = {100 * bound / ms:.1f}% of bound; "
          f"reduce_kernel {main_dev:.4f} ms, reduce_tail_kernel "
          f"{tail_dev:.4f} ms (profiler); bound {bound:.4f} ms (12 B a "
          f"position); torch.nonzero(result > 0) {nonzero_ms:.4f} ms; "
          f"plain {plain_ms:.3f} ms  [{name_limit}]")
    return ms, main_dev, tail_dev, nonzero_ms, plain_ms


def reduce_phase(dev, name_limit, corpora) -> dict:
    """Phase 10b: match_reduce_device on every corpus of phase 6, launch
    counts reset just before it, under torch.cuda.set_sync_debug_mode
    ("error") after one warm call each; each (ids, positions, count) equal
    to the plain reduce of the same result on the card; then its times
    (batched, and each kernel's by the profiler) against its bound
    (reduce.bound_bytes: 12 B a position) and torch.nonzero. -> the
    kernels' rows' numbers (on the DEFCON-like corpus)."""
    from pfac_tpu_torch.backends import reduce

    for _, mt, d, *_ in corpora:                  # warm
        mt.match_reduce_device(d)
    torch.cuda.synchronize()
    for k in reduce.LAUNCHES:
        reduce.LAUNCHES[k] = 0
    reduced = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _, mt, d, *_ in corpora:
            reduced.append(mt.match_reduce_device(d))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = dict(reduce.LAUNCHES)
    print(f"reduce path launches: {json.dumps(launches)} over "
          f"{len(corpora)} corpora under set_sync_debug_mode('error')")
    assert launches == dict.fromkeys(reduce.LAUNCHES, len(corpora)), launches
    err, rows = 0, None
    for (nm, mt, d, *_), (ids, pos, cnt) in zip(corpora, reduced):
        res = mt.match_device(d)
        npad = res.shape[0]
        p_ids, p_pos, p_cnt = reduce.reduce_plain(res)
        c = int(cnt)
        assert cnt.dim() == 0 and c == int(p_cnt) == int((res > 0).sum())
        err = max(err, max_abs_err(ids, p_ids), max_abs_err(pos, p_pos))
        assert err == 0, f"the reduce != plain on {nm}"
        del p_ids, p_pos
        ms, main_dev, tail_dev, nonzero_ms, plain_ms = time_reduce(
            nm, res, c, name_limit)
        if nm == "defcon_like":
            # reduce_kernel: the result in, the matches out, the status
            # words (written once); the tail: the zeros past the count
            status = 8 * (reduce.tiles(npad) + 1)
            rows = {"reduce_kernel": {
                        "ms": main_dev, "plain_ms": plain_ms,
                        "bound_ms": bound_ms(4 * npad + 8 * c + status),
                        "library_ms": nonzero_ms},
                    "reduce_tail_kernel": {
                        "ms": tail_dev, "plain_ms": plain_ms,
                        "bound_ms": bound_ms(8 * (npad - c)),
                        "library_ms": None}}
        del res
    del reduced
    torch.cuda.empty_cache()
    for k, r in rows.items():
        r.update(err=err, launches=launches[k])
    return rows


def surfaces_phase(dev) -> None:
    """Phase 10c: the C-style API's PFAC_matchFromDevice and
    PFAC_matchFromDeviceReduce on CUDA tensors, on the conformance example
    (the sieve engine and, with PFAC_TEXTURE_OFF, the lockstep walker);
    then device_fuzz, two cases of each kind under a time cap."""
    import os

    from pfac_tpu_torch.runtime import capi
    from pfac_tpu_torch.tools import device_fuzz

    pat = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "pattern", "example_pattern")
    d = torch.frombuffer(bytearray(b"ABEDEDABG"), dtype=torch.uint8).to(dev)
    for texture in (capi.PFAC_AUTOMATIC, capi.PFAC_TEXTURE_OFF):
        h = []
        assert capi.PFAC_create(h, device=dev) == capi.PFAC_STATUS_SUCCESS
        assert capi.PFAC_setTextureMode(h[0], texture) == 0
        assert capi.PFAC_readPatternFromFile(h[0], pat) == 0
        out, ids, pos, cnt = [], [], [], []
        assert capi.PFAC_matchFromDevice(h[0], d, 9, out) == 0
        assert out[0].device == d.device
        assert out[0][:9].tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]
        assert capi.PFAC_matchFromDeviceReduce(h[0], d, 9, ids, pos,
                                               cnt) == 0
        assert cnt == [5] and pos[0][:5].tolist() == [0, 1, 2, 4, 6]
        assert ids[0][:5].tolist() == [1, 3, 4, 4, 2]
        eng = type(h[0].matcher._engine()).__name__
        assert capi.PFAC_destroy(h[0]) == 0
        print(f"capi: PFAC_matchFromDevice and PFAC_matchFromDeviceReduce on "
              f"CUDA tensors, texture mode {texture.name}: {eng}, ok")
    for kind in device_fuzz.KINDS:
        rc = device_fuzz.main(["--cases", "2", "--seed", "7", "--kind", kind,
                               "--max-seconds", "8", "--device", str(dev)])
        assert rc == 0, f"device_fuzz {kind} failed"


def path_launches() -> dict[str, int]:
    """Each main-path kernel's launches since the counts were reset."""
    from pfac_tpu_torch.backends import (block_walk, compact, csr_walk, sieve,
                                         walk)
    return {**sieve.LAUNCHES, **compact.LAUNCHES,
            "walk_kernel": walk.LAUNCHES,
            "block_walk_kernel": block_walk.LAUNCHES,
            "csr_walk_kernel": csr_walk.LAUNCHES}


def reset_launches() -> None:
    from pfac_tpu_torch.backends import (block_walk, compact, csr_walk, sieve,
                                         walk)
    torch.cuda.synchronize()
    for c in (sieve.LAUNCHES, compact.LAUNCHES):
        for k in c:
            c[k] = 0
    walk.LAUNCHES = block_walk.LAUNCHES = csr_walk.LAUNCHES = 0


def boundary_plants(host: np.ndarray, pat: bytes, shard_len: int,
                    n: int) -> tuple[np.ndarray, list[int]]:
    """A copy of `host` with `pat` planted across every shard boundary:
    starting on the shard's last byte at odd boundaries (the match needs
    len(pat) - 1 bytes of the halo), ending on the next shard's first byte
    at even ones. -> (the copy, the boundaries)."""
    out = host.copy()
    p = np.frombuffer(pat, np.uint8)
    bounds = list(range(shard_len, n - len(pat), shard_len))
    for k, b in enumerate(bounds, 1):
        s = b - 1 if k % 2 else b - len(pat) + 1
        out[s:s + len(pat)] = p
    return out, bounds


def sharded_phase(dev, name_limit, corpora) -> None:
    """Phase 11: the sharded matcher (``dist/sharding.py``) on the card.
    The sieve engine on 2 and 4 shards of `dev` over the random,
    DEFCON-like, big-ruleset and all-match corpora of phase 6: launch
    counts reset just before each match_device and read just after (every
    kernel of the tier once a shard), the shards' results concatenated
    equal in full to the single-device match_device, the count to its
    matching positions, match_reduce to the single device's
    match_reduce_device (int64 positions), and match_device again under
    torch.cuda.set_sync_debug_mode("error"); the longest pattern planted
    across every shard boundary of the random and big-ruleset corpora,
    against the golden model around each boundary and the single device in
    full; a process group of one rank (NCCL) with 2 local shards, its halo
    heads and count through NCCL; the walker engine sharded over SLICE
    bytes; bench_scaling's lines for 1, 2 and 4 shards on the random and
    DEFCON-like corpora, and the host's time a call split between the
    engine and the sharded wrapper; device_fuzz --sharded, two cases of
    each kind under a time cap."""
    import os
    import tempfile

    import torch.distributed as dist

    from pfac_tpu_torch.backends import golden
    from pfac_tpu_torch.backends.sieve_matcher import npad_for
    from pfac_tpu_torch.backends.xla import XlaMatcher
    from pfac_tpu_torch.dist import multihost
    from pfac_tpu_torch.dist.sharding import ShardedMatcher, make_data_mesh
    from pfac_tpu_torch.tools import bench_scaling, device_fuzz

    t11 = time.perf_counter()
    by_name = {c[0]: c for c in corpora}
    picked = [by_name[k] for k in ("random", "defcon_like", "big_ruleset",
                                   "all_match")]

    def sharded(mt, mesh):
        # the single device's engine, tables and all, serves every shard
        sm = ShardedMatcher(mt.automaton, mesh=mesh, engine=mt._engine())
        assert sm.engine == "sieve" and list(sm._engines.values()) == [
            mt._engine()]
        return sm

    for nm, mt, d, host, *_ in picked:
        e = mt._engine()
        n = d.shape[0]
        single = mt.match_device(d)
        matching = int((single > 0).sum())
        s_ids, s_pos, s_cnt = mt.match_reduce_device(d)
        c = int(s_cnt)
        s_ids, s_pos = s_ids[:c].cpu().numpy(), s_pos[:c].cpu().numpy()
        for k in (2, 4):
            sm = sharded(mt, make_data_mesh(devices=[dev] * k))
            sl = sm._shard_len(n)
            shards = sm._put(d, sl)
            sm.match_device(shards, n)                     # warm
            reset_launches()
            res, cnt = sm.match_device(shards, n)
            torch.cuda.synchronize()
            per = {kk: v for kk, v in path_launches().items() if v}
            assert sum(per.get(kk, 0) for kk in (
                "sieve_smem_kernel", "sieve_cluster_kernel",
                "sieve_global_kernel")) == k, (nm, per)
            assert per["compact_scan_kernel"] == per["compact_kernel"] == k
            assert per.get("walk_kernel", 0) == k * (e._walk is not None)
            assert per.get("block_walk_kernel", 0) == \
                k * (e._walk is not None)
            assert per.get("csr_walk_kernel", 0) == k * (e._csr is not None)
            cat = torch.cat(res)
            assert torch.equal(cat[:n], single[:n]), f"{nm} {k} shards"
            assert not cat[n:].any() and not single[n:].any()
            assert cnt.dim() == 0 and int(cnt) == matching, (nm, int(cnt))
            del cat, res
            torch.cuda.set_sync_debug_mode("error")
            try:
                again, _ = sm.match_device(shards, n)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            del again
            ids, pos, cc = sm.match_reduce(host)
            assert cc == c and pos.dtype == np.int64, (nm, cc, c)
            assert np.array_equal(pos, s_pos) and np.array_equal(ids, s_ids)
            del ids, pos
            print(f"sharded {nm} {k} shards of {sl} bytes (halo {sm.halo}) "
                  f"on one card: equal in full to the single device; count "
                  f"{matching}; match_reduce equal ({c} matches, int64 "
                  f"positions); no host synchronisation in match_device; "
                  f"launches {json.dumps(per)}")
            del sm, shards
            torch.cuda.empty_cache()
        del single

    # the longest pattern across every boundary of 4 shards
    for nm in ("random", "big_ruleset"):
        _, mt, _, host, *_ = by_name[nm]
        a = mt.automaton
        pat = max(a.sorted_patterns, key=len)
        assert len(pat) == a.max_pattern_len
        sm = sharded(mt, make_data_mesh(devices=[dev] * 4))
        n = host.shape[0]
        sl = sm._shard_len(n)
        planted, bounds = boundary_plants(host, pat, sl, n)
        pd = torch.from_numpy(planted).to(dev)
        res, _ = sm.match_device(sm._put(pd, sl), n)
        cat = torch.cat(res)
        assert torch.equal(cat[:n], mt.match_device(pd)[:n]), nm
        look = a.max_pattern_len
        got = cat.cpu().numpy()
        for k, b in enumerate(bounds, 1):
            lo, hi = b - 2 * look, b + 2 * look
            want = golden.match_edges_batch(a, planted[lo:hi + look])
            assert np.array_equal(got[lo:hi], want[:hi - lo]), (nm, b)
            s = b - 1 if k % 2 else b - len(pat) + 1
            assert want[s - lo] > 0, (nm, b)
        print(f"sharded planted {nm}: a {len(pat)}-byte pattern (the longest;"
              f" halo {sm.halo}) across each of {len(bounds)} boundaries, "
              f"equal to golden around each and to the single device in "
              f"full")
        del sm, res, cat, pd

    # a process group of one rank: heads and count through NCCL
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as tmp:
        multihost.initialize(f"file://{tmp}/store", 1, 0, [dev])
        try:
            mesh = multihost.global_mesh([dev, dev])
            assert dist.get_backend(mesh.group) == "nccl"
            for nm, mt, d, *_ in picked:
                n = d.shape[0]
                sm = sharded(mt, mesh)
                shards = sm._put(d, sm._shard_len(n))
                res, cnt = sm.match_device(shards, n)
                single = mt.match_device(d)
                cat = torch.cat(res)
                assert torch.equal(cat[:n], single[:n]), f"nccl {nm}"
                assert int(cnt) == int((single > 0).sum()), f"nccl {nm}"
                print(f"sharded nccl {nm}: a one-rank NCCL group, 2 local "
                      f"shards: equal in full to the single device, count "
                      f"{int(cnt)} by all_reduce")
                del sm, shards, res, cat, single
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()

    # the walker engine, sharded
    _, mt, d, host, *_ = by_name["random"]
    sm = ShardedMatcher(mt.automaton, mesh=make_data_mesh(devices=[dev] * 2),
                        engine="xla")
    want = XlaMatcher(mt.automaton, device=dev).match_device(d[:SLICE])
    got = sm.match(host[:SLICE])
    assert np.array_equal(got, want[:SLICE].cpu().numpy()), "sharded walker"
    print(f"sharded walker: 2 shards over {SLICE // MB} MB of random equal "
          f"to the single-device walker")
    del sm, want

    # bench_scaling's lines; then the card's busy time in a sharded call
    # (torch.profiler: every kernel of the call runs once a shard, so a
    # call's busy time is the shards times the sum of the kernels' medians)
    for nm in ("random", "defcon_like"):
        _, mt, d, host, *_ = by_name[nm]
        for line in bench_scaling.scaling_lines(
                mt.automaton, host, [1, 2, 4], f"{nm}_{CORPUS // MB}MB",
                name_limit, engine=mt._engine(), data_dev=d):
            print(f"scaling: {json.dumps(line)}")
        # where a shard's host time goes: the engine on the shard buffer
        # alone, then the sharded wrapper around it; the halo exchange
        n, eng = d.shape[0], mt._engine()
        sm1, sm4 = (sharded(mt, make_data_mesh(devices=[dev] * k))
                    for k in (1, 4))
        b1 = sm1._put(d, sm1._shard_len(n))
        sl4 = sm4._shard_len(n)
        b4 = sm4._put(d, sl4)
        npad1 = npad_for(b1[0].shape[0], eng.tile_rows)
        split = {
            "single match_device": lambda: eng.match_device(d),
            "engine on the 1-shard buffer": lambda: eng._run(b1[0], n, npad1),
            "sharded _run, 1 shard": lambda: sm1._run(b1, n),
            "halo exchange, 4 shards": lambda: sm4._exchange_halos(b4, sl4)}
        ms = {k: bench_scaling._host_ms(f, [dev], reps=50)
              for k, f in split.items()}
        print(f"sharded host split {nm}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in ms.items())
            + f" (host medians of 50)  [{name_limit}]")
        del sm1, sm4, b1, b4
        for k in (1, 2, 4):
            sm = sharded(mt, make_data_mesh(devices=[dev] * k))
            n = d.shape[0]
            shards = sm._put(d, sm._shard_len(n))
            rows, wall_ms = profiled(lambda: sm._run(shards, n), 5)
            busy = k * sum(t for t, _, key in rows if "Memcpy" not in key)
            print(f"breakdown sharded {nm} {k} shards: device busy "
                  f"{busy:.4f} ms a call, host wall {wall_ms:.4f} ms a call "
                  f"under the profiler (5 calls)  [{name_limit}]")
            for t, c, key in rows[:6]:
                print(f"  {t:.4f} ms  {c} recorded  {key[:64]}")
            del sm, shards
    torch.cuda.empty_cache()

    for kind in device_fuzz.KINDS:
        rc = device_fuzz.main(["--cases", "2", "--seed", "11", "--kind", kind,
                               "--max-seconds", "5", "--device", str(dev),
                               "--sharded", "--shards", "3"])
        assert rc == 0, f"device_fuzz --sharded {kind} failed"
    print(f"phase 11: {time.perf_counter() - t11:.1f} s")


def entry_points_phase(dev, name_limit, walker_time, floor_text) -> None:
    """Phase 12: tools/bench, tools/bench_matrix and tools/graft_entry on
    the card; `walker_time` and `floor_text` are phase 8's."""
    from torch.profiler import ProfilerActivity, profile

    from pfac_tpu_torch.backends import (block_walk, compact, pipeline,
                                         sieve, walk)
    from pfac_tpu_torch.backends.sieve_matcher import npad_for
    from pfac_tpu_torch.experiments.gathers import cuda_ms
    from pfac_tpu_torch.tools import bench, bench_matrix, graft_entry

    t12 = time.perf_counter()
    torch.cuda.empty_cache()
    print(f"bench: {json.dumps(bench.run(dev))}", flush=True)
    card = bench.card_of(dev)
    t0 = time.perf_counter()
    runs = bench_matrix.prepare(dev)
    t_prep = time.perf_counter() - t0
    for r in runs:
        bench_matrix.check(r)
    print(f"bench_matrix: {len(runs)} regimes ready in {t_prep:.1f} s; every "
          f"gate passed in {time.perf_counter() - t0 - t_prep:.1f} s "
          f"(virus_dense_worst equal in full to the plain pipeline and "
          f"match_dense_batch; reduce_device_3pct equal in full to "
          f"reduce_plain)", flush=True)
    by = {r.name: r for r in runs}

    # virus_dense_worst: the main path counted, then again where any host
    # synchronisation raises
    v = by["virus_dense_worst"]
    eng, d = v.engine, v.data
    n, block = d.shape[0], eng.tile_rows * 128
    npad = npad_for(n, eng.tile_rows)
    want = eng.match_device(d)
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = eng.match_device(d)
    torch.cuda.synchronize()
    per = {k: c for k, c in path_launches().items() if c}
    nonzero = sum(e.count for e in prof.key_averages()
                  if e.key == "aten::nonzero")
    base, bits, counts = sieve.sieve(d, n, npad, eng._sieve, block)
    escaped = block_walk.escaped_blocks(counts, npad)
    assert per == {"sieve_smem_kernel": 1, "compact_scan_kernel": 1,
                   "compact_kernel": 1, "walk_kernel": 1,
                   "block_walk_kernel": 1}, per
    assert nonzero == 0 and escaped == 0, (nonzero, escaped)
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = eng.match_device(d)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(res, want) and torch.equal(again, want)
    print(f"main path virus_dense_worst: {n // MB} MB equal to the plain "
          f"pipeline and golden (gates above); launches {json.dumps(per)} "
          f"(K3's grid reads the counts on the card and walks {escaped} of "
          f"{counts.numel()} blocks: the fullest holds "
          f"{int(counts.max())} survivors, the escape needs "
          f"{block // block_walk.DENSE_ESCAPE_DIV}); aten::nonzero calls: "
          f"{nonzero}; again under set_sync_debug_mode('error'): no host "
          f"synchronisation, equal")
    del again, res, want

    pos, cnt = compact.compact(bits, counts,
                               pipeline.threshold(eng._walk, block))
    ms2, prof2, plain2, bound2, n2, deep2, floor2 = walker_time(
        "walk_kernel", "virus_dense_worst", walk.walk, d, base, pos, cnt,
        eng._walk, walk.walk_plain, v.regime.patterns)
    plan2, grid2 = walk.launch_plan(eng._walk, dev)[1], walk.grid(eng._walk,
                                                                  dev)
    print(f"time K2 walk_kernel virus_dense_worst ({n2} survivors, {deep2} "
          f"deep matches; grid {grid2} CTAs x 1024 threads, "
          f"{min(grid2, n2)} in use; {4 * plan2} of "
          f"{4 * eng._walk.arena.numel()} arena bytes resident): {ms2:.4f} "
          f"ms batched, {prof2:.4f} ms profiler (plain {plain2:.3f} ms, "
          f"bound {bound2:.5f} ms{floor_text(floor2)})  [{name_limit}]")
    # K2 by survivors a lane: the first 1x and 2x the grid's lanes, all
    lanes, parts = grid2 * 1024, []
    for k in sorted({min(lanes, n2), min(2 * lanes, n2), n2}):
        cnt_k = torch.tensor([k], dtype=torch.int32, device=dev)
        out = base.clone()
        fn = (lambda out=out, cnt_k=cnt_k:
              walk.walk(d, n, pos, out, eng._walk, cnt_k))
        t = kernel_ms(device_ms(fn, need=("walk_kernel",)), "walk_kernel",
                      cuda_ms(fn, batch=10))
        parts.append(f"{k} ({k / lanes:.2f} a lane) {t:.4f} ms")
    print(f"time K2 walk_kernel virus_dense_worst by survivors (profiler): "
          f"{'; '.join(parts)}  [{name_limit}]")
    del base, bits, counts, pos, cnt, out
    ms_e = cuda_ms(lambda: eng.match_device(d))
    rows, _ = profiled(lambda: eng.match_device(d), 5)
    busy = sum(t for t, _, _ in rows)
    print(f"time match_device virus_dense_worst {n // MB} MB: {ms_e:.4f} ms "
          f"= {n / ms_e / 1e6:.2f} GB/s; device busy {busy:.4f} ms = "
          f"{100 * busy / ms_e:.1f}% of it  [{name_limit}]")
    for t, c, key in rows[:6]:
        print(f"  {t:.4f} ms  {100 * t / busy:5.1f}%  {c} recorded  "
              f"{key[:64]}")

    surv = {nm: bench_matrix.survivors(by[nm]) for nm in (
        "defcon_like_1.5pct", "virus_dense_worst", "big_ruleset_100k_defcon")}
    print(f"survivors: {json.dumps(surv)} (the reference's records: "
          f"98316, 396847, 4690)")
    assert surv["defcon_like_1.5pct"] == 98_316, surv
    assert surv["virus_dense_worst"] == 396_847, surv
    # the reduce at 3% matches, as phase 10 times it on the main path's
    # results
    time_reduce("reduce_device_3pct", by["reduce_device_3pct"].data,
                by["reduce_device_3pct"].extra["matches"], name_limit)
    for r in runs:
        print(f"regime: {json.dumps(bench_matrix.measure(r, card))}",
              flush=True)
    del runs, by, v, eng, d
    torch.cuda.empty_cache()

    fn, args = graft_entry.entry(dev)
    out = fn(*args)
    cpu_fn, cpu_args = graft_entry.entry("cpu")
    assert torch.equal(out.cpu(), cpu_fn(*cpu_args)), "entry() != CPU"
    print(f"entry(): ran on {dev}, out shape {tuple(out.shape)}, equal to "
          f"the CPU's")
    graft_entry.dryrun_multichip(4, [dev] * 4)
    print(f"phase 12: {time.perf_counter() - t12:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    import pfac_tpu_torch as pt
    from pfac_tpu_torch import _build
    from pfac_tpu_torch.backends import (block_walk, compact, csr_walk,
                                         pipeline, sieve, walk)
    from pfac_tpu_torch.backends.csr_tables import build_csr_tables
    from pfac_tpu_torch.backends.sieve_matcher import npad_for
    from pfac_tpu_torch.backends.sieve_tables import SieveTables
    from pfac_tpu_torch.experiments import (align_micro, axis0_gather_probe,
                                            dyngather_micro, gather_micro,
                                            gathers, harness,
                                            lanegather2_micro,
                                            lanegather_micro, rulesets)
    cuda_ms = gathers.cuda_ms

    # 1. the card
    dev = torch.device("cuda:0")
    name_limit = harness.card()
    kind = torch.cuda.get_device_name(0)
    print(name_limit)                  # as nvidia-smi prints it
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, {_build.ARCH}, "
          f"{len(_build.sources())} sources in parallel)")
    # the process's first CUDA window of torch.profiler, spent on nothing
    profiled(lambda: torch.zeros(1, device=dev), 1)

    # 3. conformance on the card
    m = pt.Matcher([b"AB", b"ABG", b"BEDE", b"ED"], device="cuda")
    got = m.match(b"ABEDEDABG").tolist()
    assert got == [1, 3, 4, 0, 4, 0, 2, 0, 0], got
    ids, pos, n_red = m.match_reduce(b"ABEDEDABG")
    assert (n_red, pos.tolist(), ids.tolist()) == (
        5, [0, 1, 2, 4, 6], [1, 3, 4, 4, 2])
    print("conformance: ok")

    # 4. set-up: the Snort workload (walk-table tier)
    t0 = time.perf_counter()
    pats = rulesets.snort_like_patterns()
    a = pt.Automaton.from_patterns(pats)
    m = pt.Matcher(automaton=a, device="cuda")
    eng = m._engine()
    rng = np.random.default_rng(42)
    rand = rng.integers(0, 256, size=CORPUS, dtype=np.uint8)
    defcon = rulesets.planted_text(rng, pats, CORPUS, 0.015)
    rand_d = torch.from_numpy(rand).to(dev)
    def_d = torch.from_numpy(defcon).to(dev)
    wt = eng.walk_tables
    print(f"workload: {len(pats)} patterns, max_len {a.max_pattern_len}, "
          f"{len(wt.steps)} walk steps, arenas "
          f"{eng._sieve.arena.numel() * 4} + {eng._walk.arena.numel() * 4} "
          f"bytes; K1 placement {sieve.placement_for(eng._sieve)} "
          f"({sieve.smem_bytes('smem', eng._sieve)} B of shared memory); "
          f"set-up {time.perf_counter() - t0:.1f} s")

    # the big ruleset (CSR tier)
    brng = np.random.default_rng(7)
    t0 = time.perf_counter()
    bpats = rulesets.clamav_like_patterns(brng)
    ab = pt.Automaton.from_patterns(bpats)
    t_auto = time.perf_counter() - t0
    t0 = time.perf_counter()
    st_big = SieveTables.build(ab)
    t_sieve = time.perf_counter() - t0
    t0 = time.perf_counter()
    ct = build_csr_tables(ab)
    t_csr = time.perf_counter() - t0
    print(f"big ruleset: {len(bpats)} patterns, max_len {ab.max_pattern_len}; "
          f"automaton {t_auto:.1f} s; sieve tables {t_sieve:.1f} s, "
          f"{st_big.vmem_bytes} bytes (reference layout); CSR tables "
          f"{t_csr:.1f} s, {ct.table_bytes / 1e6:.1f} MB, {len(ct.steps)} "
          f"steps, max chain {max(s.chain for s in ct.steps)}, entry width "
          f"{ct.entry_width}")
    t0 = time.perf_counter()
    mb = pt.Matcher(automaton=ab, device="cuda")
    engb = mb._engine()
    assert engb.walk_tables is None and engb.csr_tables is not None
    big = rulesets.planted_text(brng, bpats, CORPUS, 0.002)
    big_d = torch.from_numpy(big).to(dev)
    big_place = sieve.placement_for(engb._sieve)
    print(f"big ruleset engine: sieve arena {engb._sieve.arena.numel() * 4} "
          f"bytes (residuals from word {sieve.residual_offset(engb._sieve)}),"
          f" K1 placement {big_place} "
          f"({sieve.smem_bytes(big_place, engb._sieve)} B of shared memory "
          f"per CTA); CSR arena {engb._csr.arena.numel() * 4} bytes; engine "
          f"+ corpus {time.perf_counter() - t0:.1f} s")

    # Benchmark I and the mixed-density corpus (walk-table tier + escape)
    m1 = pt.Matcher([b"aaaa"], device="cuda")
    eng1 = m1._engine()
    all_a = np.full(BENCH1, ord("a"), np.uint8)
    all_b = np.full(BENCH1, ord("b"), np.uint8)
    a_d = torch.from_numpy(all_a).to(dev)
    b_d = torch.from_numpy(all_b).to(dev)
    mpats = pats + [b"zzzz", b"zzzzzzzz"]
    mm = pt.Matcher(mpats, device="cuda")
    engm = mm._engine()
    block = engm.tile_rows * 128
    thresh = block // block_walk.DENSE_ESCAPE_DIV
    mixed = rulesets.mixed_density(np.random.default_rng(3), mpats, MIXED,
                                   block)
    mix_d = torch.from_numpy(mixed).to(dev)

    # 5. each kernel against its plain version
    npad_s = npad_for(SLICE)
    k1 = {}
    for nm, d, tabs, place in (("Snort", rand_d, eng._sieve, "smem"),
                               ("100K", big_d, engb._sieve, "cluster"),
                               ("100K", big_d, engb._sieve, "global")):
        sl = d[:SLICE]
        got = sieve.sieve(sl, SLICE, npad_s, tabs, placement=place)
        want = sieve.sieve_plain(sl, SLICE, npad_s, tabs)
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        assert err == 0, f"K1 {place} != plain"
        k1[place] = err
        print(f"K1 vs plain: {place} placement, {nm} arena, {SLICE // MB} MB "
              f"slice: match, bitmap and per-block counts bit-equal "
              f"({int(got[2].sum())} survivors)")
    assert sieve.placement_for(eng._sieve) == "smem"

    npad = npad_for(CORPUS)
    base, bits, counts = sieve.sieve(def_d, CORPUS, npad, eng._sieve)
    bbase, bbits, bcounts = sieve.sieve(big_d, CORPUS, npad, engb._sieve)
    mbase, mbits, mcounts = sieve.sieve(mix_d, MIXED, npad_for(MIXED),
                                        engm._sieve)
    compact_err = 0
    for nm, bt, cn, th in (("DEFCON-like", bits, counts, thresh),
                           ("big-ruleset", bbits, bcounts, block + 1),
                           ("mixed", mbits, mcounts, thresh)):
        pk, pc = compact.compact(bt, cn, th)
        pp = compact.compact_plain(bt, cn, th)
        compact_err = max(compact_err, max_abs_err(pk[:int(pc)], pp))
        assert compact_err == 0, f"compaction != plain on {nm}"
        print(f"compaction vs plain: {nm}, {int(pc)} positions in a buffer "
              f"of {pk.numel()} ({4 * pk.numel() / 1e6:.1f} MB), threshold "
              f"{th}: bit-equal")

    def walker_cases(nm, run, plain, d, pos, count, base_, tabs) -> int:
        """A walker against its plain version on the exact positions: the
        pipeline's buffer and device count, a buffer longer than its count
        whose words past it are survivors (not to be walked), a count of
        0, and a data view 3 bytes in (its own survivors). -> max error."""
        exact = pos[:int(count)]
        one = lambda k: torch.tensor([k], dtype=torch.int32, device=dev)
        view, vn = d[3:], d.shape[0] - 3
        vpos = (exact[exact >= 3] - 3).contiguous()
        cases = [("buffer and device count", d, d.shape[0], pos, count, exact),
                 ("buffer past the count", d, d.shape[0], exact,
                  one(exact.numel() // 2), exact[:exact.numel() // 2]),
                 ("count 0", d, d.shape[0], exact, one(0), exact[:0]),
                 ("unaligned view (data % 16 = "
                  f"{view.data_ptr() % 16})", view, vn, vpos, None, vpos)]
        err = 0
        for case, dd, nn, buf, cnt, want_pos in cases:
            ok, op = base_.clone(), base_.clone()
            run(dd, nn, buf, ok, tabs, cnt)
            plain(dd, nn, want_pos, op, tabs)
            err = max(err, max_abs_err(ok, op))
            assert err == 0, f"{nm} != plain: {case}"
            print(f"{nm} vs plain: {case}, {want_pos.numel()} survivors "
                  f"walked, bit-equal ({int((ok != base_).sum())} deep "
                  f"matches)")
        return err

    surv, surv_n = compact.compact(bits, counts, thresh)
    k2_err = walker_cases("K2", walk.walk, walk.walk_plain, def_d, surv,
                          surv_n, base, eng._walk)
    out_k = base.clone()
    walk.walk(def_d, CORPUS, surv, out_k, eng._walk, surv_n)
    k2_deep = int((out_k != base).sum())

    bsurv, bsurv_n = compact.compact(bbits, bcounts, block + 1)
    k4_err = walker_cases("CSR walk", csr_walk.csr_walk,
                          csr_walk.csr_walk_plain, big_d, bsurv, bsurv_n,
                          bbase, engb._csr)
    bout_k = bbase.clone()
    csr_walk.csr_walk(big_d, CORPUS, bsurv, bout_k, engb._csr, bsurv_n)
    k4_deep = int((bout_k != bbase).sum())

    def k3_case(nm: str, d: torch.Tensor, n: int, e) -> int:
        """K3 against block_walk_plain on d[:n]; keeps the inputs."""
        npd = npad_for(n)
        base3, _, counts3 = sieve.sieve(d, n, npd, e._sieve)
        esc = block_walk.escaped_blocks(counts3, npd)
        mk3 = base3.clone()
        block_walk.block_walk(d, n, counts3, mk3, e._walk)
        mp3 = base3.clone()
        block_walk.block_walk_plain(d, n, counts3, mp3, e._walk)
        err = max_abs_err(mk3, mp3)
        assert err == 0, f"K3 != plain on {nm}"
        deep = int((mk3 != base3).sum())
        k3_inputs[nm] = (d, n, counts3, base3, e, esc, deep)
        print(f"K3 vs plain: {nm} {n / MB:.2f} MB (data % 16 = "
              f"{d.data_ptr() % 16}), {esc} of {counts3.numel()} blocks "
              f"escaped, bit-equal ({deep} deep matches)")
        return err

    k3_inputs = {}
    n_cut = 20 * block + 5 * block_walk.CHUNK + 3
    long_pats = [b"z" * 1000 + b"y", b"zzzz", b"z" * 600 + b"y"]
    long_eng = pt.Matcher(long_pats, device="cuda")._engine()
    long_host = bytearray(b"z" * (2 * block + 500) + b"y" + bytes(3000))
    long_host[40000:40001] = b"y"
    long_d = torch.frombuffer(long_host, dtype=torch.uint8).to(dev)
    k3_err = max(
        k3_case("all_match", a_d, BENCH1, eng1),
        k3_case("mixed", mix_d, MIXED, engm),
        k3_case("random", rand_d, CORPUS, eng),
        k3_case("all_match cut block", a_d, n_cut, eng1),
        k3_case("all_match unaligned view", a_d[1:], SLICE + 5, eng1),
        k3_case("mixed unaligned view", mix_d[3:], MIXED - 3, engm),
        k3_case("long patterns", long_d, len(long_host), long_eng))
    assert k3_inputs["all_match cut block"][5] == 21
    assert k3_inputs["mixed unaligned view"][5] > 0
    assert k3_inputs["random"][5] == 0 and k3_inputs["random"][6] == 0
    assert k3_inputs["long patterns"][5] == 2
    # G2 on each of its paths, forced, at E5's three shapes
    for case in axis0_gather_probe.cases(dev, paths=("direct", "staged")):
        assert harness.check(case) == 0
        print(f"G2 vs plain: {case.name}: bit-equal ({case.kernel})")
    del got, want
    torch.cuda.empty_cache()

    # F1: walk-tier tables whose entry tables alone outgrow the walk
    # kernels' shared memory (ROADMAP.md): 17,000 random 6-byte patterns
    # (seed 17000) and zzzz, zzzzzzzz, on F1_BYTES of random bytes with a
    # pattern planted every 177 bytes and one dense block of z
    t0 = time.perf_counter()
    frng = np.random.default_rng(17000)
    fpats = [bytes(frng.integers(0, 256, size=6, dtype=np.uint8))
             for _ in range(17000)] + [b"zzzz", b"zzzzzzzz"]
    mf = pt.Matcher(fpats, device="cuda")
    engf = mf._engine()
    f1 = rulesets.mixed_density(np.random.default_rng(5), fpats, F1_BYTES,
                                F1_BYTES)
    f1[5 * block:6 * block] = ord("z")
    f1_d = torch.from_numpy(f1).to(dev)
    f1_k2 = walk.launch_plan(engf._walk, dev)[1]
    f1_k3 = block_walk.launch_plan(
        engf._walk, npad_for(F1_BYTES) // block_walk.CHUNK, dev)[3]
    print(f"f1 ruleset: {len(fpats)} patterns, walk arena "
          f"{engf._walk.arena.numel() * 4} bytes, entry tables "
          f"{4 * walk.table_ends(engf._walk)[1]} bytes; arena words resident "
          f"in shared memory: K2 {f1_k2}, K3 {f1_k3}; set-up "
          f"{time.perf_counter() - t0:.1f} s")

    # 6. the main path on every corpus, counted
    corpora = [
        ("random", m, rand_d, rand, SLICE, GOLDEN_SECONDS),
        ("defcon_like", m, def_d, defcon, SLICE, GOLDEN_SECONDS),
        ("big_ruleset", mb, big_d, big, BIG_SLICE, 0.0),
        ("all_match", m1, a_d, all_a, SLICE, 0.0),
        ("no_match", m1, b_d, all_b, SLICE, 0.0),
        ("mixed", mm, mix_d, mixed, SLICE, 0.0),
        ("f1_entry_tables", mf, f1_d, f1, F1_BYTES, GOLDEN_SECONDS),
    ]
    counters = (sieve.LAUNCHES, compact.LAUNCHES)

    def launches() -> dict[str, int]:
        return {**sieve.LAUNCHES, **compact.LAUNCHES,
                "walk_kernel": walk.LAUNCHES,
                "block_walk_kernel": block_walk.LAUNCHES,
                "csr_walk_kernel": csr_walk.LAUNCHES}

    torch.cuda.synchronize()
    for c in counters:
        for k in c:
            c[k] = 0
    walk.LAUNCHES = block_walk.LAUNCHES = csr_walk.LAUNCHES = 0
    results, per_corpus = [], []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _, mt, d, _, _, _ in corpora:
            before = launches()
            results.append(mt.match_device(d))
            after = launches()
            per_corpus.append({k: after[k] - before[k] for k in after})
    torch.cuda.synchronize()
    main_launches = launches()
    nonzero = sum(e.count for e in prof.key_averages()
                  if e.key == "aten::nonzero")
    print(f"main path launches: {json.dumps(main_launches)}; aten::nonzero "
          f"calls: {nonzero}")
    assert nonzero == 0, "the main path called torch.nonzero"
    # no host synchronisation: the same calls again, warm, where any
    # synchronising call raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = [mt.match_device(d) for _, mt, d, _, _, _ in corpora]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(torch.equal(a_, r_) for a_, r_ in zip(again, results))
    del again
    print(f"sync check: match_device on {len(corpora)} corpora under "
          f"torch.cuda.set_sync_debug_mode('error'): no host "
          f"synchronisation, results equal")
    for (nm, mt, d, host, step, secs), res, per in zip(corpora, results,
                                                       per_corpus):
        e = mt._engine()
        assert sum(per[k] for k in sieve.LAUNCHES) == 1, (nm, per)
        assert per["compact_scan_kernel"] == per["compact_kernel"] == 1, \
            (nm, per)
        # each tier's walker launches once a call, whatever the count
        assert per["walk_kernel"] == (e._walk is not None), (nm, per)
        assert per["csr_walk_kernel"] == (e._csr is not None), (nm, per)
        assert per["block_walk_kernel"] == (e._walk is not None), (nm, per)
        n = d.shape[0]
        npd = npad_for(n)
        assert res.dtype == torch.int32 and res.shape[0] == npd
        plain = pipeline.run(d, n, npd, e._sieve, e._walk, e._csr,
                             plain=True)
        assert torch.equal(res, plain), f"{nm}: match_device != plain"
        assert not res[n:].any()
        del plain
        esc = 0
        if e._walk is not None:
            _, _, cnt = sieve.sieve(d, n, npd, e._sieve)
            esc = block_walk.escaped_blocks(cnt, npd)
        print(f"main path {nm}: {n // MB} MB equal to the plain pipeline; "
              f"{int((res > 0).sum())} matching positions; {esc} blocks "
              f"escaped; launches "
              f"{json.dumps({k: v for k, v in per.items() if v})}")
        if nm in ("all_match", "mixed", "f1_entry_tables"):
            assert esc > 0, f"{nm}: the escape was not taken"
        golden_check(mt.automaton, host, res, nm, step, secs)
    del results
    torch.cuda.empty_cache()

    # 7. every kernel of the path ran
    path = ["sieve_smem_kernel", f"sieve_{big_place}_kernel",
            "compact_scan_kernel", "compact_kernel", "walk_kernel",
            "block_walk_kernel", "csr_walk_kernel"]
    assert all(main_launches[k] > 0 for k in path), main_launches

    # 8. times (CUDA events, median; card and limit above). A kernel's time
    # is taken over batches of calls, so that it is the card's time and not
    # the wrapper's host time; match_device is timed one call at a time,
    # host included, as a caller sees it
    nblocks = npad // block
    batch = harness.BATCH
    print(f"clocks before phase 8 (sm, max sm, power, temperature): "
          f"{harness.clocks()}")

    def k1_bytes(n: int, npd: int) -> int:
        # input once; match, bitmap and counts written once
        return n + 4 * npd + npd // 8 + 4 * (npd // block)

    k1_ms = cuda_ms(lambda: sieve.sieve(rand_d, CORPUS, npad, eng._sieve),
                    batch=batch)
    k1_plain = cuda_ms(
        lambda: sieve.sieve_plain(rand_d, CORPUS, npad, eng._sieve),
        reps=3, warmup=1)
    # the 100K arena's two placements, in turns within this run
    turns = {"cluster": [], "global": []}
    for place in ("cluster", "global", "global", "cluster"):
        turns[place].append(cuda_ms(lambda: sieve.sieve(
            big_d, CORPUS, npad, engb._sieve, placement=place), batch=batch))
    k1_big = {p: float(np.median(v)) for p, v in turns.items()}
    k1_big_plain = cuda_ms(
        lambda: sieve.sieve_plain(big_d, CORPUS, npad, engb._sieve),
        reps=3, warmup=1)
    k1_bound = bound_ms(k1_bytes(CORPUS, npad))
    print(f"time K1 sieve_smem_kernel {CORPUS // MB} MB random (Snort arena "
          f"in shared memory): {k1_ms:.4f} ms (plain {k1_plain:.3f} ms, "
          f"bound {k1_bound:.4f} ms)  [{name_limit}]")
    for place in ("cluster", "global"):
        print(f"time K1 sieve_{place}_kernel {CORPUS // MB} MB big-ruleset "
              f"(100K arena, {place}): {k1_big[place]:.4f} ms, turns "
              f"{', '.join(f'{t:.4f}' for t in turns[place])} (plain "
              f"{k1_big_plain:.3f} ms, bound {k1_bound:.4f} ms)  "
              f"[{name_limit}]")

    # compaction of the DEFCON-like survivors: the wrapper (two launches,
    # the count left on the device), each kernel's device time, the plain
    # version and torch.nonzero over the same positions as uint8 flags
    surv_exact = surv[:int(surv_n)]
    flags_u8 = sieve.unpack_bits(bits)
    flags_u8.view(nblocks, -1)[counts >= thresh] = 0
    assert torch.equal(torch.nonzero(flags_u8).reshape(-1).to(torch.int32),
                       surv_exact)
    comp_ms = cuda_ms(lambda: compact.compact(bits, counts, thresh))
    comp_plain = cuda_ms(lambda: compact.compact_plain(bits, counts, thresh),
                         reps=3, warmup=1)
    nonzero_ms = cuda_ms(lambda: torch.nonzero(flags_u8), batch=batch)
    comp_dev = device_ms(lambda: compact.compact(bits, counts, thresh),
                         need=("compact_scan_kernel", "compact_kernel"))
    scan_ms = kernel_ms(comp_dev, "compact_scan_kernel", comp_ms)
    expand_ms = kernel_ms(comp_dev, "compact_kernel", comp_ms)
    live = int(((counts > 0) & (counts < thresh)).sum())
    scan_bound = bound_ms(4 * nblocks + 4 * (nblocks + 1))
    expand_bound = bound_ms(8 * nblocks + live * (block // 8)
                            + 4 * surv_exact.numel())
    print(f"time compaction DEFCON-like {CORPUS // MB} MB, "
          f"{surv_exact.numel()} survivors: wrapper {comp_ms:.4f} ms "
          f"(compact_scan_kernel {scan_ms:.4f} ms, bound {scan_bound:.4f}; "
          f"compact_kernel {expand_ms:.4f} ms, bound {expand_bound:.4f}; "
          f"torch.nonzero over uint8 flags {nonzero_ms:.4f} ms; plain "
          f"{comp_plain:.3f} ms)  [{name_limit}]")
    del flags_u8

    # the walks only write deep matches, so repeating one on one buffer
    # repeats the same work and leaves the same result. A walk reads each
    # survivor's position and at least its 4 entry bytes, and writes its
    # deep match
    def walker_time(kernel, nm, run, d, base_, pos, count, tabs, plain=None,
                    plist=None):
        """-> (batched ms, profiler ms, plain ms or None, bound ms, survivors,
        deep matches, floor) of a walker on the pipeline's buffer and count.
        With the pattern list `plist`, floor is (profiler ms, bytes) of the
        walker on the one survivor whose match is longest alone: the chain
        of the run's deepest walk, which no spreading of survivors over
        lanes can shorten; else None."""
        out = base_.clone()
        fn = lambda: run(d, d.shape[0], pos, out, tabs, count)
        fn()
        ms_ = cuda_ms(fn, batch=batch)
        prof = kernel_ms(device_ms(fn, need=(kernel,)), kernel, ms_)
        exact = pos[:int(count)]
        plain_ms = None
        if plain is not None:
            op = base_.clone()
            plain_ms = cuda_ms(lambda: plain(d, d.shape[0], exact, op, tabs),
                               reps=3, warmup=1)
            assert torch.equal(out, op), f"{nm}: {kernel} != plain"
        deep = int((out != base_).sum())
        floor = None
        if plist is not None:
            lens = torch.tensor([0] + [len(q) for q in plist], device=dev)
            at = int(torch.argmax(lens[out[exact.long()].long()]))
            one = exact[at:at + 1].clone()
            alone = lambda: run(d, d.shape[0], one, out, tabs)
            floor = (kernel_ms(device_ms(alone, need=(kernel,)), kernel,
                               cuda_ms(alone)),
                     int(lens[out[one.long()].long()]))
        return (ms_, prof, plain_ms, bound_ms(8 * exact.numel() + 4 * deep),
                exact.numel(), deep, floor)

    def floor_text(floor) -> str:
        return ("" if floor is None else f"; the longest match's walk alone "
                f"({floor[1]} bytes) {floor[0]:.4f} ms profiler")

    rbase, rbits, rcounts = sieve.sieve(rand_d, CORPUS, npad, eng._sieve)
    k2_inputs = {
        "defcon_like": (def_d, base, surv, surv_n),
        "random": (rand_d, rbase,
                   *compact.compact(rbits, rcounts, thresh)),
        "mixed": (mix_d, mbase, *compact.compact(mbits, mcounts, thresh))}
    k2 = {}
    for nm, (d, b_, pos_, cnt_) in k2_inputs.items():
        e = mm._engine() if nm == "mixed" else eng
        k2[nm] = walker_time("walk_kernel", nm, walk.walk, d, b_, pos_, cnt_,
                             e._walk, *((walk.walk_plain, pats)
                                        if nm == "defcon_like" else ()))
        ms2, prof2, plain2, bound2, n2, deep2, floor2 = k2[nm]
        plan2, grid2 = walk.launch_plan(e._walk, dev)[1], walk.grid(e._walk,
                                                                    dev)
        print(f"time K2 walk_kernel {nm} ({n2} survivors, {deep2} deep "
              f"matches; grid {grid2} CTAs x 1024 threads, "
              f"{min(grid2, n2)} in use; {4 * plan2} of "
              f"{4 * e._walk.arena.numel()} arena bytes resident): {ms2:.4f} "
              f"ms batched, {prof2:.4f} ms profiler (plain "
              f"{'not run' if plain2 is None else f'{plain2:.3f} ms'}, bound "
              f"{bound2:.5f} ms{floor_text(floor2)})  [{name_limit}]")
    del rbase, rbits, rcounts, k2_inputs
    # K2 on the DEFCON-like survivors with less of the arena resident: none,
    # the entry tables, K3's prefix, and its own plan (what a deeper
    # residency could still win)
    key = ("k2_plan", dev.index)
    plan = walk.launch_plan(eng._walk, dev)
    sweep = {"none": 0, "entry": walk.table_ends(eng._walk)[1],
             "K3's prefix": block_walk.launch_plan(
                 eng._walk, npad // block_walk.CHUNK, dev)[3],
             "K2's plan": plan[1]}
    parts = []
    try:
        for nm, words in sweep.items():
            eng._walk.derived[key] = (plan[0], words)
            out = base.clone()
            fn = lambda: walk.walk(def_d, CORPUS, surv, out, eng._walk, surv_n)
            fn()
            prof = kernel_ms(device_ms(fn, need=("walk_kernel",)),
                             "walk_kernel", cuda_ms(fn, batch=batch))
            assert torch.equal(out, out_k), f"K2 resident {nm} != plain"
            parts.append(f"{nm} {4 * words} B {prof:.4f} ms")
    finally:
        eng._walk.derived[key] = plan
    print(f"time K2 walk_kernel defcon_like by resident arena (profiler): "
          f"{'; '.join(parts)}  [{name_limit}]")
    del out
    k2_ms, _, k2_plain, k2_bound, _, _, _ = k2["defcon_like"]
    k4_ms, k4_prof, k4_plain, k4_bound, k4_n, _, k4_floor = walker_time(
        "csr_walk_kernel", "big_ruleset", csr_walk.csr_walk, big_d, bbase,
        bsurv, bsurv_n, engb._csr, csr_walk.csr_walk_plain, bpats)
    print(f"time csr_walk_kernel big_ruleset ({k4_n} survivors, {k4_deep} "
          f"deep matches; grid {csr_walk.grid(engb._csr, dev)} CTAs x 256 "
          f"threads; {len(engb._csr.rows)} descriptor rows in shared "
          f"memory): {k4_ms:.4f} ms batched, {k4_prof:.4f} ms profiler "
          f"(plain {k4_plain:.3f} ms, bound {k4_bound:.5f} ms"
          f"{floor_text(k4_floor)})  [{name_limit}]")
    # K3: the dense blocks' bytes and the counts read, the deep matches
    # written; repeating it rewrites the same words
    k3 = {}
    for nm in ("all_match", "mixed", "random"):
        d, n, counts3, base3, e, esc3, deep3 = k3_inputs[nm]
        mk3 = base3.clone()
        run3 = (lambda d=d, n=n, c=counts3, o=mk3, e=e:
                block_walk.block_walk(d, n, c, o, e._walk))
        ms3 = cuda_ms(run3, batch=batch)
        prof3 = kernel_ms(device_ms(run3, need=("block_walk_kernel",)),
                          "block_walk_kernel", ms3)
        mp3 = base3.clone()
        plain3 = cuda_ms(lambda: block_walk.block_walk_plain(
            d, n, counts3, mp3, e._walk), reps=3, warmup=1)
        assert torch.equal(mk3, mp3)
        bound3 = bound_ms(min(n, esc3 * block) + 4 * deep3
                          + 4 * counts3.numel())
        nst, _, cap3, res3 = block_walk.launch_plan(
            e._walk, base3.numel() // block_walk.CHUNK, dev)
        tiles3 = len(block_walk.dense_tiles(n, counts3, block))
        k3[nm] = (ms3, plain3, bound3)
        print(f"time K3 block_walk_kernel {nm} {n // MB} MB ({esc3} blocks, "
              f"{tiles3} tiles, {deep3} deep matches; {res3} of "
              f"{e._walk.arena.numel()} arena words resident, "
              f"{block_walk.fixed_smem_bytes(nst, cap3) + 4 * res3} B of "
              f"shared memory): {ms3:.4f} ms batched, {prof3:.4f} ms profiler "
              f"(plain {plain3:.3f} ms, bound {bound3:.4f} ms)  "
              f"[{name_limit}]")
        del mk3, mp3
    k3_ms, k3_plain, k3_bound = k3["all_match"]
    torch.cuda.empty_cache()
    # match_device end to end (CUDA events, one call at a time), and the
    # device's busy share of it: the sum of a call's kernels' profiler
    # times over the e2e median (no kernel runs twice in a call)
    for nm, mt, d, _, _, _ in corpora:
        ms = cuda_ms(lambda: mt.match_device(d))
        n = d.shape[0]
        rows, wall_ms = profiled(lambda: mt.match_device(d), 5)
        busy = sum(t for t, _, _ in rows)
        print(f"time match_device {nm} {n / MB:.0f} MB: {ms:.4f} ms = "
              f"{n / ms / 1e6:.2f} GB/s; device busy {busy:.4f} ms = "
              f"{100 * busy / ms:.1f}% of it  [{name_limit}]")
        print(f"breakdown {nm}: device busy {busy:.4f} ms per call, "
              f"{100 * busy / wall_ms:.1f}% of host wall time {wall_ms:.4f} "
              f"ms under the profiler (5 calls)")
        for t, c, key in rows[:8]:
            print(f"  {t:.4f} ms  {100 * t / busy:5.1f}%  {c} recorded  "
                  f"{key[:64]}")
    ms = cuda_ms(lambda: pipeline.run(a_d, BENCH1, npad_for(BENCH1),
                                      eng1._sieve, eng1._walk, escape=False))
    print(f"time all_match {BENCH1 // MB} MB escape disarmed (K2 over every "
          f"survivor): {ms:.4f} ms = {BENCH1 / ms / 1e6:.2f} GB/s  "
          f"[{name_limit}]")
    print(f"clocks after phase 8 (sm, max sm, power, temperature): "
          f"{harness.clocks()}")

    # 9. the gather micro-benchmarks E1-E6 at full size and the sweep over
    # the four arenas, launch counts reset just before them
    t9 = time.perf_counter()
    micro = itertools.chain(
        lanegather_micro.cases(dev), gather_micro.cases(dev),
        dyngather_micro.cases(dev), align_micro.cases(dev),
        axis0_gather_probe.cases(dev, paths=(None, "direct", "staged")),
        lanegather2_micro.cases(dev),
        gather_micro.arena_cases(gather_micro.arenas_of(eng, engb)))
    torch.cuda.synchronize()
    for k in gathers.LAUNCHES:
        gathers.LAUNCHES[k] = 0
    checked, g_err = [], dict.fromkeys(gathers.LAUNCHES, 0)
    for item in micro:
        if isinstance(item, harness.Refusal):
            print(harness.refuse(item))
            continue
        g_err[item.kernel] = max(g_err[item.kernel], harness.check(item))
        item.expect = None
        checked.append(item)
    torch.cuda.synchronize()
    g_launches = dict(gathers.LAUNCHES)
    print(f"micro-benchmark launches: {json.dumps(g_launches)}; "
          f"{len(checked)} cases bit-equal to their plain versions and to "
          f"the reference cases' numpy expectations")
    assert all(v > 0 for v in g_launches.values()), g_launches
    timed = [harness.measure(c, name_limit) for c in checked]
    # the launch-bound G2 cases: the card's own time of the kernel and of
    # torch.gather's (profiler), beside the batched times above
    for c in checked:
        if c.kernel.startswith("tile_gather") and c.lookups <= 1 << 16:
            ours = kernel_ms(device_ms(c.run, need=(c.kernel,)), c.kernel,
                             next(t["ms"] for t in timed
                                  if t["name"] == c.name))
            lib = device_ms(c.library)
            print(f"device time {c.name}: {c.kernel} {ours:.4f} ms, "
                  f"torch.gather's {len(lib)} kernel(s) "
                  f"{sum(lib.values()):.4f} ms  [{name_limit}]")
    # G1 on E1 C/D, E2 and the E6 planes (every placement and the default
    # one), and G4 on E4: the card's own time of the kernel and, for G1, of
    # torch.take's (torch.profiler)
    for c in checked:
        if not (c.kernel == "align_kernel" or (
                c.kernel.startswith("word_gather")
                and c.name[:2] in ("E1", "E2", "E6"))):
            continue
        wrapper = next(t["ms"] for t in timed if t["name"] == c.name)
        ours = kernel_ms(device_ms(c.run, need=(c.kernel,)), c.kernel,
                         wrapper)
        lib = ""
        if c.library is not None:
            lt = device_ms(c.library)
            lib = (f", torch.take's {len(lt)} kernel(s) "
                   f"{sum(lt.values()):.4f} ms")
        print(f"device time {c.name}: {c.kernel} {ours:.4f} ms{lib}, bound "
              f"{c.bound_ms:.4f} ms (wrapper {wrapper:.4f} ms)  "
              f"[{name_limit}]")
    del checked
    print(f"phase 9: {time.perf_counter() - t9:.1f} s")

    # 10. the lockstep walker, the device reduce, the C-style API and the
    # fuzz on the card
    t10 = time.perf_counter()
    torch.cuda.empty_cache()
    lockstep_phase(dev, name_limit, a, m,
                   [("random", rand_d, rand), ("defcon_like", def_d, defcon)],
                   (ab, mb, big_d, big))
    red = reduce_phase(dev, name_limit, corpora)
    surfaces_phase(dev)
    print(f"phase 10: {time.perf_counter() - t10:.1f} s")

    # 11. the sharded matcher
    sharded_phase(dev, name_limit, corpora)

    # 12. the system's own entry points
    entry_points_phase(dev, name_limit, walker_time, floor_text)

    def pick(kernel: str, *keys: str) -> dict:
        return next(t for t in timed if t["kernel"] == kernel
                    and all(k in t["name"] for k in keys))

    # K1's table-load rate (its batched time from phase 8) beside G1's and
    # G3's over the same arena
    for nm, ms, tabs, arena in (
            ("Snort", k1_ms, eng._sieve, "snort_sieve"),
            ("100K", k1_big[big_place], engb._sieve, "100k_sieve")):
        loads = gather_micro.k1_loads(tabs.rows)
        g1 = pick("word_gather_kernel", arena, "G1 ldg")
        g3 = pick("chain_gather_kernel", arena, "ldg")
        print(f"K1 {nm}: {loads} table loads per position x {CORPUS} "
              f"positions in {ms:.4f} ms = {loads * CORPUS / ms / 1e6:.2f} G "
              f"loads/s; over the same arena G1 ldg "
              f"{g1['lookups'] / g1['ms'] / 1e6:.2f}, G3 chain 4 ldg "
              f"{g3['lookups'] / g3['ms'] / 1e6:.2f} G lookups/s  "
              f"[{name_limit}]")

    rep = {"word_gather_kernel": pick("word_gather_kernel", "snort_sieve",
                                      "G1 ldg"),
           "word_gather_cluster_kernel": pick("word_gather_cluster_kernel",
                                              "E2 take_grid", "cluster"),
           "tile_gather_kernel": pick("tile_gather_kernel", "E1 A"),
           "tile_gather_direct_kernel": pick("tile_gather_direct_kernel",
                                             "E5 a"),
           "chain_gather_kernel": pick("chain_gather_kernel", "E3 rows=4096",
                                       "chain=4 smem"),
           "align_kernel": pick("align_kernel", "E4")}
    replaces = {
        "word_gather_kernel": "experiments/lanegather_micro.py:46 (cases C "
                              ":98, D :130); experiments/gather_micro.py:39, "
                              ":62, :103; experiments/lanegather2_micro.py:101",
        "tile_gather_kernel": "experiments/lanegather_micro.py:46 (case A "
                              ":63); experiments/lanegather2_micro.py:49; "
                              "experiments/axis0_gather_probe.py:35",
        "chain_gather_kernel": "experiments/dyngather_micro.py:40",
        "align_kernel": "experiments/align_micro.py:63"}
    replaces["tile_gather_direct_kernel"] = replaces["tile_gather_kernel"]
    replaces["word_gather_cluster_kernel"] = replaces["word_gather_kernel"]

    def row(name, source, replaces_, err, ms_, plain_ms, bound, library=None):
        return {"name": name, "route": "cuda",
                "source": f"pfac_tpu_torch/csrc/{source}",
                "replaces": replaces_, "launches": main_launches.get(name, 0),
                "max_abs_err": err, "ms": ms_, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": "bytes",
                "library_ms": library}

    kernels = [
        row("sieve_smem_kernel", "sieve.cu",
            "pfac_tpu/backends/pallas_sieve.py:418", k1["smem"], k1_ms,
            k1_plain, k1_bound),
        row(f"sieve_{big_place}_kernel", "sieve.cu",
            "pfac_tpu/backends/pallas_sieve.py:418", k1[big_place],
            k1_big[big_place], k1_big_plain, k1_bound),
        row("compact_scan_kernel", "compact.cu",
            "pfac_tpu/backends/pallas_sieve.py:882 (_compact, XLA)",
            compact_err, scan_ms, comp_plain, scan_bound),
        row("compact_kernel", "compact.cu",
            "pfac_tpu/backends/pallas_sieve.py:882 (_compact, XLA)",
            compact_err, expand_ms, comp_plain, expand_bound, nonzero_ms),
        row("walk_kernel", "walk.cu", "pfac_tpu/backends/pallas_walk.py:360",
            k2_err, k2_ms, k2_plain, k2_bound),
        row("block_walk_kernel", "block_walk.cu",
            "pfac_tpu/backends/pallas_sieve.py:678", k3_err, k3_ms, k3_plain,
            k3_bound),
        row("csr_walk_kernel", "csr_walk.cu",
            "pfac_tpu/backends/pallas_walk.py:664", k4_err, k4_ms, k4_plain,
            k4_bound),
    ]
    for k, r_ in red.items():
        r = row(k, "reduce.cu",
                "pfac_tpu/backends/xla.py:476 (_reduce_rowgather, XLA)",
                r_["err"], r_["ms"], r_["plain_ms"], r_["bound_ms"],
                r_["library_ms"])
        r["launches"] = r_["launches"]
        kernels.append(r)
    for k in gathers.LAUNCHES:
        r = row(k, "gather_micro.cu", replaces[k], g_err[k], rep[k]["ms"],
                rep[k]["plain_ms"], rep[k]["bound_ms"], rep[k]["library_ms"])
        r["launches"] = g_launches[k]
        kernels.append(r)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   survivors, the CSR walk on the big corpus's survivors, K3 on the
   all-match and mixed corpora;
6. the main path on every corpus, launch counts reset just before it, under
   torch.profiler: no ``aten::nonzero`` ran; K1 and both compaction kernels
   launched on every corpus; each result equal in full to the port's plain
   pipeline on the card, and to the port's numpy golden oracle
   (golden.match_edges_batch) on >= 16 MB of each corpus (>= 4 MB of the
   big-ruleset corpus, where the oracle is slow); the escape taken on the
   all-match and mixed corpora;
7. every kernel of the path launched;
8. CUDA-event times (median after warm-up; a kernel over batches of 10
   calls, match_device one call at a time) of each kernel, its plain
   version, its library yardstick where one PyTorch call computes the same
   function (``torch.nonzero`` over uint8 flags for the compaction), and
   its bound; the compaction's two kernels by torch.profiler; the 100K
   arena's two placements in turns; match_device end to end on every
   corpus and the all-match corpus with the escape disarmed; torch.profiler
   breakdowns; the card's clocks before and after;
9. the table-probe micro-benchmarks (``pfac_tpu_torch.experiments``, the
   counterparts of the reference's E1-E6) at full size, and G1/G3 over the
   four arenas built above, launch counts reset just before them: every
   case bit-equal to its plain version and to the reference case's numpy
   expectation, every placement that must refuse its table refused, each
   of the four kernels G1-G4 launched; then a ``time`` line per case (with
   ``torch.take`` / ``torch.gather`` beside G1 / G2).

Then one JSON line of per-kernel results (every kernel of the main path and
G1-G4, each with its bound and library time), and last
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
SLICE = 16 * MB
BIG_SLICE = 4 * MB         # golden slice of the big-ruleset corpus
GOLDEN_SECONDS = 20.0      # per corpus: widen the golden check while time allows
HBM = 3.35e12              # H100 SXM device memory, bytes/s (data sheet)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM * 1e3


def device_ms(fn, reps: int = 10) -> dict[str, float]:
    """torch.profiler device time per call of each kernel fn launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / reps / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def kernel_ms(times: dict[str, float], kernel: str) -> float:
    """The device time of the kernel named `kernel` in device_ms's dict."""
    hits = [t for k, t in times.items() if f"{kernel}(" in k]
    if len(hits) != 1:
        raise AssertionError(f"{kernel}: not one profiler row in {times}")
    return hits[0]


def breakdown(name: str, fn, reps: int = 5) -> None:
    """Device time by kernel over `reps` calls (torch.profiler), and the
    device's busy share of the host wall time of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats the time of the kernels it launched
    rows = sorted(((e.self_device_time_total, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(t for t, _ in rows)
    if not rows:
        print(f"breakdown {name}: the profiler saw no device time")
        return
    print(f"breakdown {name}: device busy {busy / reps / 1e3:.4f} ms per "
          f"call, {100 * busy / wall_us:.1f}% of host wall time "
          f"{wall_us / reps / 1e3:.4f} ms")
    for t, key in rows[:8]:
        print(f"  {t / reps / 1e3:.4f} ms  {100 * t / busy:5.1f}%  {key[:70]}")


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
        pk = compact.compact(bt, cn, th)
        pp = compact.compact_plain(bt, cn, th)
        compact_err = max(compact_err, max_abs_err(pk, pp))
        assert compact_err == 0, f"compaction != plain on {nm}"
        print(f"compaction vs plain: {nm}, {pk.numel()} positions, threshold "
              f"{th}: bit-equal")
    surv = compact.compact(bits, counts, thresh)
    out_k = base.clone()
    walk.walk(def_d, CORPUS, surv, out_k, eng._walk)
    out_p = base.clone()
    walk.walk_plain(def_d, CORPUS, surv, out_p, eng._walk)
    k2_err = max_abs_err(out_k, out_p)
    assert k2_err == 0, "K2 != plain"
    k2_deep = int((out_k != base).sum())
    print(f"K2 vs plain: DEFCON-like {CORPUS // MB} MB, {surv.numel()} "
          f"survivors bit-equal ({k2_deep} deep matches)")

    bsurv = compact.compact(bbits, bcounts, block + 1)
    bout_k = bbase.clone()
    csr_walk.csr_walk(big_d, CORPUS, bsurv, bout_k, engb._csr)
    bout_p = bbase.clone()
    csr_walk.csr_walk_plain(big_d, CORPUS, bsurv, bout_p, engb._csr)
    k4_err = max_abs_err(bout_k, bout_p)
    assert k4_err == 0, "CSR walk != plain"
    k4_deep = int((bout_k != bbase).sum())
    print(f"CSR walk vs plain: big-ruleset {CORPUS // MB} MB, {bsurv.numel()} "
          f"survivors bit-equal ({k4_deep} deep matches)")

    k3_err = 0
    k3_inputs = {}
    for nm, d, e in (("all_match", a_d, eng1), ("mixed", mix_d, engm)):
        n = d.shape[0]
        npd = npad_for(n)
        base3, _, counts3 = sieve.sieve(d, n, npd, e._sieve)
        esc = block_walk.escaped_blocks(counts3, npd)
        mk3 = base3.clone()
        block_walk.block_walk(d, n, counts3, mk3, e._walk)
        mp3 = base3.clone()
        block_walk.block_walk_plain(d, n, counts3, mp3, e._walk)
        err = max_abs_err(mk3, mp3)
        assert err == 0, f"K3 != plain on {nm}"
        k3_err = max(k3_err, err)
        deep = int((mk3 != base3).sum())
        k3_inputs[nm] = (d, n, counts3, base3, e, esc, deep)
        print(f"K3 vs plain: {nm} {n // MB} MB, {esc} of {counts3.numel()} "
              f"blocks escaped, bit-equal ({deep} deep matches)")
    del mk3, mp3, out_p, bout_p, got, want
    torch.cuda.empty_cache()

    # 6. the main path on every corpus, counted
    corpora = [
        ("random", m, rand_d, rand, SLICE, GOLDEN_SECONDS),
        ("defcon_like", m, def_d, defcon, SLICE, GOLDEN_SECONDS),
        ("big_ruleset", mb, big_d, big, BIG_SLICE, 0.0),
        ("all_match", m1, a_d, all_a, SLICE, 0.0),
        ("no_match", m1, b_d, all_b, SLICE, 0.0),
        ("mixed", mm, mix_d, mixed, SLICE, 0.0),
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
    for (nm, mt, d, host, step, secs), res, per in zip(corpora, results,
                                                       per_corpus):
        assert sum(per[k] for k in sieve.LAUNCHES) == 1, (nm, per)
        assert per["compact_scan_kernel"] == per["compact_kernel"] == 1, \
            (nm, per)
        e = mt._engine()
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
        if nm in ("all_match", "mixed"):
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

    # compaction of the DEFCON-like survivors: the wrapper (two launches and
    # the 4-byte copy of the total), each kernel's device time, the plain
    # version and torch.nonzero over the same positions as uint8 flags
    flags_u8 = sieve.unpack_bits(bits)
    flags_u8.view(nblocks, -1)[counts >= thresh] = 0
    assert torch.equal(torch.nonzero(flags_u8).reshape(-1).to(torch.int32),
                       surv)
    comp_ms = cuda_ms(lambda: compact.compact(bits, counts, thresh))
    comp_plain = cuda_ms(lambda: compact.compact_plain(bits, counts, thresh),
                         reps=3, warmup=1)
    nonzero_ms = cuda_ms(lambda: torch.nonzero(flags_u8), batch=batch)
    comp_dev = device_ms(lambda: compact.compact(bits, counts, thresh))
    scan_ms = kernel_ms(comp_dev, "compact_scan_kernel")
    expand_ms = kernel_ms(comp_dev, "compact_kernel")
    live = int(((counts > 0) & (counts < thresh)).sum())
    scan_bound = bound_ms(4 * nblocks + 4 * (nblocks + 1))
    expand_bound = bound_ms(8 * nblocks + live * (block // 8)
                            + 4 * surv.numel())
    print(f"time compaction DEFCON-like {CORPUS // MB} MB, {surv.numel()} "
          f"survivors: wrapper {comp_ms:.4f} ms (compact_scan_kernel "
          f"{scan_ms:.4f} ms, bound {scan_bound:.4f}; compact_kernel "
          f"{expand_ms:.4f} ms, bound {expand_bound:.4f}; torch.nonzero over "
          f"uint8 flags {nonzero_ms:.4f} ms; plain {comp_plain:.3f} ms)  "
          f"[{name_limit}]")
    del flags_u8

    # the walks only write deep matches, so repeating one on one buffer
    # repeats the same work and leaves the same result
    k2_ms = cuda_ms(lambda: walk.walk(def_d, CORPUS, surv, out_k, eng._walk),
                    batch=batch)
    out_p = base.clone()
    k2_plain = cuda_ms(
        lambda: walk.walk_plain(def_d, CORPUS, surv, out_p, eng._walk),
        reps=3, warmup=1)
    assert torch.equal(out_k, out_p)
    k4_ms = cuda_ms(
        lambda: csr_walk.csr_walk(big_d, CORPUS, bsurv, bout_k, engb._csr),
        batch=batch)
    bout_p = bbase.clone()
    k4_plain = cuda_ms(
        lambda: csr_walk.csr_walk_plain(big_d, CORPUS, bsurv, bout_p,
                                        engb._csr), reps=3, warmup=1)
    assert torch.equal(bout_k, bout_p)
    # a walk reads each survivor's position and at least its 4 entry
    # bytes, and writes its deep match
    k2_bound = bound_ms(8 * surv.numel() + 4 * k2_deep)
    k4_bound = bound_ms(8 * bsurv.numel() + 4 * k4_deep)
    d, n, counts3, base3, e, esc3, deep3 = k3_inputs["all_match"]
    mk3 = base3.clone()
    k3_ms = cuda_ms(lambda: block_walk.block_walk(d, n, counts3, mk3,
                                                  e._walk), batch=batch)
    mp3 = base3.clone()
    k3_plain = cuda_ms(lambda: block_walk.block_walk_plain(
        d, n, counts3, mp3, e._walk), reps=3, warmup=1)
    assert torch.equal(mk3, mp3)
    # the dense blocks' bytes read, their deep matches written
    k3_bound = bound_ms(min(n, esc3 * block) + 4 * deep3)
    del mk3, mp3, out_p, bout_p
    torch.cuda.empty_cache()
    print(f"time K2 walk_kernel {surv.numel()} DEFCON-like survivors: "
          f"{k2_ms:.4f} ms (plain {k2_plain:.3f} ms, bound {k2_bound:.4f} "
          f"ms)  [{name_limit}]")
    print(f"time K3 block_walk_kernel all-match {BENCH1 // MB} MB ({esc3} "
          f"blocks): {k3_ms:.4f} ms (plain {k3_plain:.3f} ms, bound "
          f"{k3_bound:.4f} ms)  [{name_limit}]")
    print(f"time csr_walk_kernel {bsurv.numel()} big-ruleset survivors: "
          f"{k4_ms:.4f} ms (plain {k4_plain:.3f} ms, bound {k4_bound:.4f} "
          f"ms)  [{name_limit}]")
    for nm, mt, d, _, _, _ in corpora:
        ms = cuda_ms(lambda: mt.match_device(d))
        n = d.shape[0]
        print(f"time match_device {nm} {n // MB} MB: {ms:.4f} ms = "
              f"{n / ms / 1e6:.2f} GB/s  [{name_limit}]")
    ms = cuda_ms(lambda: pipeline.run(a_d, BENCH1, npad_for(BENCH1),
                                      eng1._sieve, eng1._walk, escape=False))
    print(f"time all_match {BENCH1 // MB} MB escape disarmed (K2 over every "
          f"survivor): {ms:.4f} ms = {BENCH1 / ms / 1e6:.2f} GB/s  "
          f"[{name_limit}]")
    for nm, mt, d, _, _, _ in corpora:
        breakdown(nm, lambda: mt.match_device(d))
    print(f"clocks after phase 8 (sm, max sm, power, temperature): "
          f"{harness.clocks()}")

    # 9. the gather micro-benchmarks E1-E6 at full size and the sweep over
    # the four arenas, launch counts reset just before them
    t9 = time.perf_counter()
    micro = itertools.chain(
        lanegather_micro.cases(dev), gather_micro.cases(dev),
        dyngather_micro.cases(dev), align_micro.cases(dev),
        axis0_gather_probe.cases(dev), lanegather2_micro.cases(dev),
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
    del checked
    print(f"phase 9: {time.perf_counter() - t9:.1f} s")

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
           "tile_gather_kernel": pick("tile_gather_kernel", "E1 A"),
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
        row("block_walk_kernel", "walk.cu",
            "pfac_tpu/backends/pallas_sieve.py:678", k3_err, k3_ms, k3_plain,
            k3_bound),
        row("csr_walk_kernel", "csr_walk.cu",
            "pfac_tpu/backends/pallas_walk.py:664", k4_err, k4_ms, k4_plain,
            k4_bound),
    ]
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

"""Smoke run of the PyTorch/CUDA port (pfac_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, ``Matcher(device="cuda").match_device``, on
both device tiers at full size:

* walk-table tier (K1 sieve, K3 dense-block escape, K2 survivor walk):
  2,000 Snort-like patterns (``bench.py``) over a 128 MB random corpus, a
  128 MB DEFCON-like corpus (text with 1.5% planted pattern bytes) and a
  16 MB mixed-density corpus (``tests/test_pallas_sieve.py``'s recipe at
  full block size: one dense block in 16); the pattern ``aaaa`` over 100 MB
  of ``a`` (every block dense) and 100 MB of ``b`` (no match), the
  reference's Benchmark I corpora;
* CSR tier (K1, then the CSR walk): 100,000 ClamAV-scale signatures
  (``tools_bench_matrix.py``'s recipe) over 128 MB of printable text with
  0.2% planted signature bytes.

Phases, each on lines of its own:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the kernels from pfac_tpu_torch/csrc and print the build time;
3. conformance example on the card (match and match_reduce);
4. set-up of both rulesets and all corpora (seconds, table sizes);
5. every kernel against its plain torch version on the card, bit-equal:
   K1 on a 16 MB random slice, K2 on the DEFCON-like survivors, the CSR
   walk on the big corpus's survivors, K3 on the all-match and mixed
   corpora;
6. the main path on every corpus, launch counts reset just before it:
   each result equal in full to the port's plain pipeline on the card, and
   to the numpy golden oracle (golden.match_edges_batch) on >= 16 MB of
   each corpus (>= 4 MB of the big-ruleset corpus, where the oracle is
   slow); the escape taken on the all-match and mixed corpora;
7. every kernel launched by the main path;
8. CUDA-event times (median after warm-up) of each kernel and its plain
   version, of match_device end to end on every corpus, of the all-match
   corpus with the escape disarmed, and torch.profiler breakdowns;
9. the table-probe micro-benchmarks (``pfac_tpu_torch.experiments``, the
   counterparts of the reference's E1-E6) at full size, and G1/G3 over the
   four arenas built above, launch counts reset just before them: every
   case bit-equal to its plain version and to the reference case's numpy
   expectation, every placement that must refuse its table refused, each
   of the four kernels G1-G4 launched; then a ``time`` line per case and
   K1's table-load rate beside G1's over the same arena.

Then one JSON line of per-kernel results (K1-K4, G1-G4), and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result; so does a machine without a GPU.
Integer IDs are compared exactly (tolerance 0).
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


def planted_text(rng, pats, n: int, share: float) -> np.ndarray:
    """Printable text with `share` of its bytes planted pattern copies."""
    buf = bytearray(rng.integers(32, 127, size=n, dtype=np.uint8).tobytes())
    placed, budget = 0, int(n * share)
    while placed < budget:
        p = pats[int(rng.integers(0, len(pats)))]
        off = int(rng.integers(0, n - len(p)))
        buf[off:off + len(p)] = p
        placed += len(p)
    return np.frombuffer(buf, dtype=np.uint8)


def clamav_like_patterns(rng, k: int = 100_000) -> list[bytes]:
    """tools_bench_matrix.py's big ruleset: lengths gamma(3, 18) + 8 clipped
    to 8-200, uniform random bytes, deduplicated."""
    lens = np.clip(rng.gamma(3.0, 18.0, size=k) + 8, 8, 200).astype(int)
    raw = rng.integers(0, 256, size=int(lens.sum()), dtype=np.uint8)
    ends = np.cumsum(lens)
    return list(dict.fromkeys(raw[e - ln:e].tobytes()
                              for e, ln in zip(ends, lens)))


def mixed_density(rng, pats, n: int, block: int) -> np.ndarray:
    """tests/test_pallas_sieve.py's mixed-density recipe at full block size:
    random bytes, every 16th block all 'z' (dense for b"zzzz"), a pattern
    planted every 177 bytes."""
    d = rng.integers(0, 256, size=n, dtype=np.uint8)
    for b0 in range(block, n, 16 * block):
        d[b0:b0 + block] = ord("z")
    for i in range(0, n - 250, 177):
        p = pats[int(rng.integers(0, len(pats)))]
        d[i:i + len(p)] = np.frombuffer(p, np.uint8)
    return d


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
    for t, key in rows[:6]:
        print(f"  {t / reps / 1e3:.4f} ms  {100 * t / busy:5.1f}%  {key[:70]}")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def golden_check(automaton, host: np.ndarray, result: torch.Tensor,
                 name: str, step: int = SLICE,
                 seconds: float = GOLDEN_SECONDS) -> None:
    """Golden oracle on successive `step`-byte slices (each with its
    lookahead) while the time budget lasts; at least one slice."""
    from pfac_tpu.backends import golden

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
    import pfac_tpu_torch as pt
    from bench import snort_like_patterns
    from pfac_tpu_torch import _build
    from pfac_tpu_torch.backends import (block_walk, csr_walk, pipeline,
                                         sieve, walk)
    from pfac_tpu_torch.backends.csr_tables import build_csr_tables
    from pfac_tpu_torch.backends.sieve_matcher import npad_for
    from pfac_tpu_torch.backends.sieve_tables import SieveTables
    from pfac_tpu_torch.experiments import (align_micro, axis0_gather_probe,
                                            dyngather_micro, gather_micro,
                                            gathers, harness,
                                            lanegather2_micro,
                                            lanegather_micro)
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
    pats = snort_like_patterns()
    a = pt.Automaton.from_patterns(pats)
    m = pt.Matcher(automaton=a, device="cuda")
    eng = m._engine()
    rng = np.random.default_rng(42)
    rand = rng.integers(0, 256, size=CORPUS, dtype=np.uint8)
    defcon = planted_text(rng, pats, CORPUS, 0.015)
    rand_d = torch.from_numpy(rand).to(dev)
    def_d = torch.from_numpy(defcon).to(dev)
    wt = eng.walk_tables
    print(f"workload: {len(pats)} patterns, max_len {a.max_pattern_len}, "
          f"{len(wt.steps)} walk steps, arenas "
          f"{eng._sieve.arena.numel() * 4} + {eng._walk.arena.numel() * 4} "
          f"bytes; set-up {time.perf_counter() - t0:.1f} s")

    # the big ruleset (CSR tier)
    brng = np.random.default_rng(7)
    t0 = time.perf_counter()
    bpats = clamav_like_patterns(brng)
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
    big = planted_text(brng, bpats, CORPUS, 0.002)
    big_d = torch.from_numpy(big).to(dev)
    print(f"big ruleset engine: sieve arena {engb._sieve.arena.numel() * 4} "
          f"bytes, CSR arena {engb._csr.arena.numel() * 4} bytes; engine + "
          f"corpus {time.perf_counter() - t0:.1f} s")

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
    mixed = mixed_density(np.random.default_rng(3), mpats, MIXED, block)
    mix_d = torch.from_numpy(mixed).to(dev)

    # 5. each kernel against its plain version
    sl = rand_d[:SLICE]
    npad_s = npad_for(SLICE)
    mk, fk, ck = sieve.sieve(sl, SLICE, npad_s, eng._sieve)
    mp, fp, cp = sieve.sieve_plain(sl, SLICE, npad_s, eng._sieve)
    k1_err = max(max_abs_err(mk, mp), max_abs_err(ck, cp))
    assert k1_err == 0 and torch.equal(mk, mp) and torch.equal(ck, cp), \
        "K1 != plain"
    sk, sp = sieve.compact(fk), sieve.compact(fp)
    assert torch.equal(sk, sp), "K1 survivors != plain"
    print(f"K1 vs plain: {SLICE // MB} MB random slice bit-equal "
          f"({sk.numel()} survivors, per-block counts equal)")

    npad = npad_for(CORPUS)
    base, flags, _ = sieve.sieve(def_d, CORPUS, npad, eng._sieve)
    surv = sieve.compact(flags)
    out_k = base.clone()
    walk.walk(def_d, CORPUS, surv, out_k, eng._walk)
    out_p = base.clone()
    walk.walk_plain(def_d, CORPUS, surv, out_p, eng._walk)
    k2_err = max_abs_err(out_k, out_p)
    assert k2_err == 0 and torch.equal(out_k, out_p), "K2 != plain"
    print(f"K2 vs plain: DEFCON-like {CORPUS // MB} MB, {surv.numel()} survivors "
          f"bit-equal ({int((out_k != base).sum())} deep matches)")

    bbase, bflags, _ = sieve.sieve(big_d, CORPUS, npad, engb._sieve)
    bsurv = sieve.compact(bflags)
    bout_k = bbase.clone()
    csr_walk.csr_walk(big_d, CORPUS, bsurv, bout_k, engb._csr)
    bout_p = bbase.clone()
    csr_walk.csr_walk_plain(big_d, CORPUS, bsurv, bout_p, engb._csr)
    k4_err = max_abs_err(bout_k, bout_p)
    assert k4_err == 0 and torch.equal(bout_k, bout_p), "CSR walk != plain"
    print(f"CSR walk vs plain: big-ruleset {CORPUS // MB} MB, {bsurv.numel()} "
          f"survivors bit-equal ({int((bout_k != bbase).sum())} deep matches)")

    k3_err = 0
    k3_inputs = {}
    for nm, d, e in (("all_match", a_d, eng1), ("mixed", mix_d, engm)):
        n = d.shape[0]
        npd = npad_for(n)
        base3, flags3, counts3 = sieve.sieve(d, n, npd, e._sieve)
        esc = block_walk.escaped_blocks(counts3, npd)
        mk3, fk3 = base3.clone(), flags3.clone()
        block_walk.block_walk(d, n, counts3, mk3, fk3, e._walk)
        mp3, fp3 = base3.clone(), flags3.clone()
        block_walk.block_walk_plain(d, n, counts3, mp3, fp3, e._walk)
        err = max(max_abs_err(mk3, mp3), max_abs_err(fk3, fp3))
        assert err == 0 and torch.equal(mk3, mp3) and torch.equal(fk3, fp3), \
            f"K3 != plain on {nm}"
        k3_err = max(k3_err, err)
        k3_inputs[nm] = (d, n, counts3, base3, flags3, e)
        print(f"K3 vs plain: {nm} {n // MB} MB, {esc} of {counts3.numel()} "
              f"blocks escaped, bit-equal ({int((mk3 != base3).sum())} deep "
              f"matches)")
    del mk, mp, fk, fp, out_p, bout_p, mp3, fp3
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
    torch.cuda.synchronize()
    sieve.LAUNCHES = walk.LAUNCHES = 0
    block_walk.LAUNCHES = csr_walk.LAUNCHES = 0
    results = [mt.match_device(d) for _, mt, d, _, _, _ in corpora]
    torch.cuda.synchronize()
    launches = {"sieve_kernel": sieve.LAUNCHES, "walk_kernel": walk.LAUNCHES,
                "block_walk_kernel": block_walk.LAUNCHES,
                "csr_walk_kernel": csr_walk.LAUNCHES}
    print(f"main path launches: {json.dumps(launches)}")
    for (nm, mt, d, host, step, secs), res in zip(corpora, results):
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
              f"escaped")
        if nm in ("all_match", "mixed"):
            assert esc > 0, f"{nm}: the escape was not taken"
        golden_check(mt.automaton, host, res, nm, step, secs)

    # 7. every kernel of the path ran
    assert all(v > 0 for v in launches.values()), launches

    # 8. times (CUDA events, median; card and limit above)
    k1_ms = cuda_ms(lambda: sieve.sieve(rand_d, CORPUS, npad, eng._sieve))
    k1_plain = cuda_ms(
        lambda: sieve.sieve_plain(rand_d, CORPUS, npad, eng._sieve),
        reps=3, warmup=1)
    k1_big = cuda_ms(lambda: sieve.sieve(big_d, CORPUS, npad, engb._sieve))
    # the walks only write deep matches, so repeating one on one buffer
    # repeats the same work and leaves the same result
    k2_ms = cuda_ms(lambda: walk.walk(def_d, CORPUS, surv, out_k, eng._walk))
    out_p = base.clone()
    k2_plain = cuda_ms(
        lambda: walk.walk_plain(def_d, CORPUS, surv, out_p, eng._walk),
        reps=3, warmup=1)
    assert torch.equal(out_k, out_p)
    k4_ms = cuda_ms(
        lambda: csr_walk.csr_walk(big_d, CORPUS, bsurv, bout_k, engb._csr))
    bout_p = bbase.clone()
    k4_plain = cuda_ms(
        lambda: csr_walk.csr_walk_plain(big_d, CORPUS, bsurv, bout_p,
                                        engb._csr), reps=3, warmup=1)
    assert torch.equal(bout_k, bout_p)
    d, n, counts3, base3, flags3, e = k3_inputs["all_match"]
    mk3, fk3 = base3.clone(), flags3.clone()
    k3_ms = cuda_ms(lambda: block_walk.block_walk(d, n, counts3, mk3, fk3,
                                                  e._walk))
    mp3, fp3 = base3.clone(), flags3.clone()
    k3_plain = cuda_ms(lambda: block_walk.block_walk_plain(
        d, n, counts3, mp3, fp3, e._walk), reps=3, warmup=1)
    assert torch.equal(mk3, mp3)
    del mk3, mp3, fk3, fp3
    torch.cuda.empty_cache()
    print(f"time K1 sieve_kernel {CORPUS // MB} MB random: {k1_ms:.4f} ms "
          f"(plain {k1_plain:.3f} ms)  [{name_limit}]")
    print(f"time K1 sieve_kernel {CORPUS // MB} MB big-ruleset "
          f"({engb._sieve.arena.numel() * 4} B arena): {k1_big:.4f} ms  "
          f"[{name_limit}]")
    print(f"time K2 walk_kernel {surv.numel()} DEFCON-like survivors: "
          f"{k2_ms:.4f} ms (plain {k2_plain:.3f} ms)  [{name_limit}]")
    print(f"time K3 block_walk_kernel all-match {BENCH1 // MB} MB "
          f"({block_walk.escaped_blocks(counts3, npad_for(n))} blocks): "
          f"{k3_ms:.4f} ms (plain {k3_plain:.3f} ms)  [{name_limit}]")
    print(f"time csr_walk_kernel {bsurv.numel()} big-ruleset survivors: "
          f"{k4_ms:.4f} ms (plain {k4_plain:.3f} ms)  [{name_limit}]")
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
    for nm, mt, d in (("random", m, rand_d), ("defcon_like", m, def_d),
                      ("big_ruleset", mb, big_d), ("all_match", m1, a_d)):
        breakdown(nm, lambda: mt.match_device(d))

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

    def pick(kernel: str, *keys: str) -> dict:
        return next(t for t in timed if t["kernel"] == kernel
                    and all(k in t["name"] for k in keys))

    # K1's table-load rate, timed as the cases are (batches of calls)
    for nm, d, tabs, arena in (("Snort", rand_d, eng._sieve, "snort_sieve"),
                               ("100K", big_d, engb._sieve, "100k_sieve")):
        ms = cuda_ms(lambda: sieve.sieve(d, CORPUS, npad, tabs),
                     batch=harness.BATCH)
        loads = gather_micro.k1_loads(tabs.rows)
        g1 = pick("word_gather_kernel", arena, "G1 ldg")
        g3 = pick("chain_gather_kernel", arena, "ldg")
        print(f"K1 {nm}: {loads} table loads per position x {CORPUS} "
              f"positions in {ms:.4f} ms = {loads * CORPUS / ms / 1e6:.2f} G "
              f"loads/s; over the same arena G1 ldg "
              f"{g1['lookups'] / g1['ms'] / 1e6:.2f}, G3 chain 4 ldg "
              f"{g3['lookups'] / g3['ms'] / 1e6:.2f} G lookups/s  "
              f"[{name_limit}]")
    print(f"phase 9: {time.perf_counter() - t9:.1f} s")
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

    print(json.dumps({"kernels": [
        {"name": "sieve_kernel", "route": "cuda",
         "source": "pfac_tpu_torch/csrc/sieve.cu",
         "replaces": "pfac_tpu/backends/pallas_sieve.py:418",
         "launches": launches["sieve_kernel"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "walk_kernel", "route": "cuda",
         "source": "pfac_tpu_torch/csrc/walk.cu",
         "replaces": "pfac_tpu/backends/pallas_walk.py:360",
         "launches": launches["walk_kernel"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain},
        {"name": "block_walk_kernel", "route": "cuda",
         "source": "pfac_tpu_torch/csrc/walk.cu",
         "replaces": "pfac_tpu/backends/pallas_sieve.py:678",
         "launches": launches["block_walk_kernel"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain},
        {"name": "csr_walk_kernel", "route": "cuda",
         "source": "pfac_tpu_torch/csrc/csr_walk.cu",
         "replaces": "pfac_tpu/backends/pallas_walk.py:664",
         "launches": launches["csr_walk_kernel"], "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain},
    ] + [
        {"name": k, "route": "cuda",
         "source": "pfac_tpu_torch/csrc/gather_micro.cu",
         "replaces": replaces[k], "launches": g_launches[k],
         "max_abs_err": g_err[k], "ms": rep[k]["ms"],
         "plain_ms": rep[k]["plain_ms"]} for k in gathers.LAUNCHES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

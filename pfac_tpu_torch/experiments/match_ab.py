"""Same-card A/B of ``match_device`` between checkouts of the repository.

    python -m pfac_tpu_torch.experiments.match_ab [--backend xla|k1|k2|compact] DIR_A DIR_B [DIR ...]

Each argument is the root of a checkout (this one is ``.``). The script runs
one worker process per argument, in the order given, so a call such as
``parent . . parent`` times the two trees in turns on one card. A worker
imports ``pfac_tpu_torch`` from its checkout, builds its kernels there,
makes the six corpora of ``chip_smoke.py`` from their seeds (with this
checkout's ``rulesets.py``, loaded by path, so every tree sees the same
bytes), and prints per corpus one JSON line: the CUDA-event median of a warm
``Matcher(device="cuda").match_device`` call (10 calls after 2 warm-up
calls), GB/s, a fingerprint of the result, the torch.profiler device time
of a launch of each kernel (median over 5 calls), the device's busy share
of the call (``busy_ms``, the sum of those kernel times, over the e2e
median: ``busy_share``; no kernel runs twice in a call), and the card's clocks,
power and temperature right after (nvidia-smi); on the walk-table tier
also K3 alone on the corpus's sieve counts (``k3_batched_ms``: the
CUDA-event median over batches of 10 ``block_walk`` calls, so the card's
time and not the wrapper's). It uses only the API every slice of the port
since the second has (``Matcher``, ``match_device``,
``_engine().tile_rows``, ``sieve.sieve``, ``block_walk.block_walk``).
Without CUDA it exits 1.

``--backend k1`` times K1 (``sieve.sieve``) alone: the Snort set on 192
MiB of the ``snort2k`` cells' text (printable bytes with 1.5% planted
copies, ``pfac_bench.corpora``), of one repeated byte that starts
no pattern and of uniform random bytes, in each of its three placements
(forced), and the 100K set on 128 MiB of its corpus in the cluster and the
global placement. A line a case: the profiler's device ms of the kernel
(median over 5 launches), the bound (1 B read, 4 B and a bit written a
position, at 3.35 TB/s), a fingerprint of match and bitmap, and, on a tree
that counts them, the short probes a position of one program call
(``short_probes``; ``null`` elsewhere).

``--backend k2`` times K2 (``walk_kernel``) where it carries the load: the
Snort set on ``virus_dense_worst`` (8 MB, drawn as ``--backend xla`` draws
it), on 64 MiB of patterns drawn and concatenated by the same recipe (the
``snort2k.virus_dense_64MB`` cell's) and on 192 MiB of the cells' text. A line a case:
the profiler's device ms of K2 inside a program call (``match_device``;
median over 20 calls) and of each other kernel, the call's CUDA-event ms,
K2 alone through its wrapper on the same survivors (``k2_batched_ms``:
batches of 10 ``walk.walk`` calls), a fingerprint, and, on a tree that
counts them, the walk steps and lane slots of one call (``walk_steps``,
``walk_slots``) and whether its K2 held the walk tables whole in
shared memory (``whole_calls``, ``split_calls``: 1 or 0; ``null``
elsewhere).

``--backend compact`` times ``compact_kernel`` where the compaction
lists: the Snort set on the 64 MiB pattern stream of ``--backend k2``
(the ``snort2k.virus_dense_64MB`` cell's recipe), on its 192 MiB of the
cells' text, and ``aaaa`` on 100 MiB of ``a`` (every block escaped), and
there again through the compaction's wrapper with the escape disarmed
(``"disarmed": true``: every position listed, as on the CSR tier). A line
a case: the profiler's device ms of ``compact_kernel`` inside a program
call (median over 20 calls; the wrapper's launch on the disarmed line) and
of each other kernel, the survivors, a fingerprint of the positions the
wrapper lists (``pos[:count]``: their number and a sum weighted by their
index, so the order counts), and, on a tree that counts them, the chunks
one program call listed word by word (``wordwise_chunks``; ``null``
elsewhere).

``--backend xla`` times the lockstep walker instead
(``Matcher(backend="xla")``, which older trees have too):
the Snort set over the random and DEFCON-like corpora in dense and hash
mode, the 100K set over its corpus in dense mode, ``aaaa`` over the
all-match corpus and the Snort set over ``virus_dense_worst`` (8 MB of
concatenated patterns, drawn next from the same stream, as
``tools/bench_matrix.py`` draws it), dense. A line a corpus and mode as
above, with the walker's placement of the pair states (``placement``:
``"smem"`` or ``"global"``; ``null`` on a tree without placements); and,
where a tree reads the pair states from shared memory, the same kernel
again with them forced through L1/L2 (``lockstep_walk(...,
pairs=None)``, a line with ``"forced": "global"``: its profiler time and
fingerprint).
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


def _corpora():
    """This checkout's ``pfac_bench/corpora``, loaded by path, so that every
    tree plants the same copies."""
    spec = importlib.util.spec_from_file_location(
        "pfac_corpora", os.path.join(HERE, "..", "..", "pfac_bench",
                                     "corpora", "__init__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ms(fn, reps: int = 10, warmup: int = 2, batch: int = 1) -> float:
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
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return float(np.median(times))


def _k3_batched(mt, d) -> float | None:
    """K3 alone on d's sieve counts, batches of 10 calls; None off the
    walk-table tier."""
    from pfac_tpu_torch.backends import block_walk, sieve
    from pfac_tpu_torch.backends.sieve_matcher import npad_for

    eng = mt._engine()
    if eng._walk is None:
        return None
    n = d.shape[0]
    match, _, counts = sieve.sieve(d, n, npad_for(n), eng._sieve)
    return _ms(lambda: block_walk.block_walk(d, n, counts, match, eng._walk),
               batch=10)


def _kernels(fn, reps: int = 5) -> dict[str, float]:
    """torch.profiler device ms of a launch of each kernel of fn: the
    median over the events it recorded with a duration. Its sums are not
    to be divided by the calls made: it may record fewer launches than
    were made, or more events than launches, and now and then none of a
    window, which is then repeated, at most four times."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans: dict[str, list[float]] = {}
        for e in prof.events():
            if (e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0):
                spans.setdefault(e.key[:60], []).append(
                    e.self_device_time_total)
        if spans:
            break
    return {k: round(float(np.median(v)) / 1e3, 4) for k, v in spans.items()}


def _clocks() -> str:
    """SM clock, its maximum, power draw and temperature (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60, check=True).stdout.strip()


def corpora(pt, dev) -> list:
    """The six corpora of chip_smoke.py, made from their seeds with this
    checkout's rulesets.py: [(name, Matcher of the tree `pt`, host bytes)]."""
    import numpy as np

    rs = _rulesets()
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
    return [("random", m, rand), ("defcon_like", m, defcon),
            ("big_ruleset", mb, big),
            ("all_match", m1, np.full(100 * MB, ord("a"), np.uint8)),
            ("no_match", m1, np.full(100 * MB, ord("b"), np.uint8)),
            ("mixed", mm, mixed)]


def walker_corpora(pt, dev) -> list:
    """The lockstep walker's cases, made from their seeds with this
    checkout's rulesets.py: [(name, perf_mode, Matcher of the tree `pt`
    with backend "xla", host bytes)]."""
    import numpy as np

    rs = _rulesets()
    pats = rs.snort_like_patterns()
    rng = np.random.default_rng(42)
    rand = rng.integers(0, 256, size=128 * MB, dtype=np.uint8)
    defcon = rs.planted_text(rng, pats, 128 * MB, 0.015)
    virus = rs.pattern_stream(rng, pats, 8 * MB)
    brng = np.random.default_rng(7)
    bpats = rs.clamav_like_patterns(brng)
    big = rs.planted_text(brng, bpats, 128 * MB, 0.002)
    snort = {mode: pt.Matcher(pats, device=dev, backend="xla",
                              perf_mode=mode) for mode in ("dense", "hash")}
    cases = [(name, mode, snort[mode], host)
             for name, host in (("random", rand), ("defcon_like", defcon))
             for mode in ("dense", "hash")]
    return cases + [
        ("big_ruleset", "dense", pt.Matcher(bpats, device=dev, backend="xla"),
         big),
        ("all_match", "dense", pt.Matcher([b"aaaa"], device=dev,
                                          backend="xla"),
         np.full(100 * MB, ord("a"), np.uint8)),
        ("virus_dense_worst", "dense", snort["dense"], virus)]


def _fingerprint(res, n: int) -> list[int]:
    import torch

    ids = res[:n].to(torch.int64)
    pos = torch.arange(ids.numel(), device=ids.device, dtype=torch.int64)
    return [int((ids > 0).sum()), int((ids * (pos % 65521)).sum())]


def walker_worker(tree: str, dev) -> None:
    import torch

    import pfac_tpu_torch as pt
    from pfac_tpu_torch.backends import lockstep

    t0 = time.perf_counter()
    cases = walker_corpora(pt, dev)
    print(f"worker {tree}: set-up {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, mode, mt, host in cases:
        d = torch.from_numpy(host).to(dev)
        eng = mt._engine()
        place = getattr(eng, "placement", None)
        n = host.shape[0]
        res = mt.match_device(d)
        ms = _ms(lambda: mt.match_device(d))
        kernels = _kernels(lambda: mt.match_device(d))
        line = {"tree": tree, "backend": "xla", "corpus": name, "mode": mode,
                "placement": place, "ms": ms, "GB/s": n / ms / 1e6,
                "fingerprint": _fingerprint(res, n), "device_ms": kernels,
                "busy_share": round(sum(kernels.values()) / ms, 4),
                "clocks": _clocks()}
        print(json.dumps(line), flush=True)
        if place == "smem":
            a = eng.automaton
            out = torch.empty_like(res)
            run = lambda: lockstep.lockstep_walk(
                d, n, out, eng._tables, perf_mode=mode,
                num_final=a.num_final_states, max_len=a.max_pattern_len)
            run()
            print(json.dumps({
                "tree": tree, "backend": "xla", "corpus": name, "mode": mode,
                "forced": "global", "fingerprint": _fingerprint(out, n),
                "device_ms": _kernels(run), "clocks": _clocks()}),
                flush=True)
            del out
        del d, res
        torch.cuda.empty_cache()


def k1_worker(tree: str, dev) -> None:
    import numpy as np
    import torch

    import pfac_tpu_torch as pt
    from pfac_tpu_torch import trace
    from pfac_tpu_torch.backends import sieve
    from pfac_tpu_torch.backends.sieve_matcher import npad_for

    rs = _rulesets()
    pats = rs.snort_like_patterns()
    m = pt.Matcher(pats, device=dev)
    n = 192 * MB
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    text = torch.randint(32, 127, (n,), generator=gen, device=dev,
                         dtype=torch.uint8)
    _corpora().plant(text, pats, 0.015, np.random.default_rng(19))
    firsts = {p[0] for p in pats}
    quiet = next(c for c in range(256) if c not in firsts)
    cases = [("text", m, text),
             (f"repeated_{quiet}", m,
              torch.full((n,), quiet, dtype=torch.uint8, device=dev)),
             ("random", m, torch.randint(0, 256, (n,), generator=gen,
                                         device=dev, dtype=torch.uint8))]
    brng = np.random.default_rng(7)
    bpats = rs.clamav_like_patterns(brng)
    big = torch.from_numpy(rs.planted_text(brng, bpats, 128 * MB, 0.002))
    cases.append(("big_ruleset", pt.Matcher(bpats, device=dev), big.to(dev)))
    for name, mt, d in cases:
        tabs = mt._engine()._sieve
        nb = d.shape[0]
        npad = npad_for(nb)
        probes = None
        if "short_probes" in getattr(trace, "DEVICE_KEYS", ()):
            mt.match_device(d)
            before = trace.device_counters()["short_probes"]
            mt.match_device(d)
            probes = (trace.device_counters()["short_probes"] - before) / npad
        places = (("cluster", "global") if name == "big_ruleset"
                  else sieve.PLACEMENTS)
        for place in places:
            run = lambda: sieve.sieve(d, nb, npad, tabs, placement=place)
            match, bits, _ = run()
            kernel = f"sieve_{place}_kernel"
            kms = next((v for k, v in _kernels(run).items() if kernel in k),
                       None)
            print(json.dumps({
                "tree": tree, "k1": name, "placement": place, "MB": nb / MB,
                "device_ms": kms,
                "bound_ms": round((nb + 4 * npad + npad / 8) / 3.35e9, 4),
                "fingerprint": _fingerprint(match, nb) + [
                    int(bits.to(torch.int64).sum())],
                "short_probes": probes, "clocks": _clocks()}), flush=True)
            del match, bits
        del d
        torch.cuda.empty_cache()


def k2_worker(tree: str, dev) -> None:
    import numpy as np
    import torch

    import pfac_tpu_torch as pt
    from pfac_tpu_torch import trace
    from pfac_tpu_torch.backends import compact, pipeline, sieve, walk
    from pfac_tpu_torch.backends.sieve_matcher import npad_for

    rs = _rulesets()
    pats = rs.snort_like_patterns()
    m = pt.Matcher(pats, device=dev)
    eng = m._engine()
    rng = np.random.default_rng(42)        # as walker_corpora draws it
    rng.integers(0, 256, size=128 * MB, dtype=np.uint8)
    rs.planted_text(rng, pats, 128 * MB, 0.015)
    virus = torch.from_numpy(rs.pattern_stream(rng, pats, 8 * MB)).to(dev)
    dense = torch.from_numpy(rs.pattern_stream(
        np.random.default_rng(20), pats, 64 * MB)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    text = torch.randint(32, 127, (192 * MB,), generator=gen, device=dev,
                         dtype=torch.uint8)
    _corpora().plant(text, pats, 0.015, np.random.default_rng(19))
    counted = "walk_steps" in getattr(trace, "DEVICE_KEYS", ())
    for name, d in (("virus_dense_worst", virus), ("pattern_stream_64MB",
                                                    dense), ("text", text)):
        n = d.shape[0]
        res = m.match_device(d)
        steps = slots = whole = split = None
        if counted:
            before, calls = trace.device_counters(), trace.counters()
            m.match_device(d)
            after, calls_after = trace.device_counters(), trace.counters()
            steps, slots = (after[k] - before[k]
                            for k in ("walk_steps", "walk_slots"))
            keys = ("walk.whole_calls", "walk.split_calls")
            if any(k in calls_after for k in keys):
                whole, split = (calls_after[k] - calls[k] for k in keys)
        kernels = _kernels(lambda: m.match_device(d), reps=20)
        k2 = next((v for k, v in kernels.items()
                   if "walk_kernel<" in k and "block_walk" not in k), None)
        base, bits, counts = sieve.sieve(d, n, npad_for(n), eng._sieve)
        pos, cnt = compact.compact(bits, counts, pipeline.threshold(
            eng._walk, eng.tile_rows * 128))
        print(json.dumps({
            "tree": tree, "k2": name, "MB": n / MB, "k2_ms": k2,
            "device_ms": kernels, "ms": _ms(lambda: m.match_device(d)),
            "k2_batched_ms": _ms(lambda: walk.walk(d, n, pos, base,
                                                   eng._walk, cnt),
                                 batch=10),
            "survivors": int(cnt), "walk_steps": steps, "walk_slots": slots,
            "whole_calls": whole, "split_calls": split,
            "fingerprint": _fingerprint(res, n), "clocks": _clocks()}),
            flush=True)
        del res, base, bits, counts, pos, cnt
        torch.cuda.empty_cache()


def _positions_fingerprint(pos, count) -> list[int]:
    import torch

    got = pos[:int(count)].to(torch.int64)
    i = torch.arange(got.numel(), device=got.device, dtype=torch.int64)
    return [got.numel(), int((got * (i % 65521 + 1)).sum())]


def compact_worker(tree: str, dev) -> None:
    import numpy as np
    import torch

    import pfac_tpu_torch as pt
    from pfac_tpu_torch import trace
    from pfac_tpu_torch.backends import compact, pipeline, sieve
    from pfac_tpu_torch.backends.sieve_matcher import npad_for

    rs = _rulesets()
    pats = rs.snort_like_patterns()
    m = pt.Matcher(pats, device=dev)
    dense = torch.from_numpy(rs.pattern_stream(
        np.random.default_rng(20), pats, 64 * MB)).to(dev)   # as k2_worker
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    text = torch.randint(32, 127, (192 * MB,), generator=gen, device=dev,
                         dtype=torch.uint8)
    _corpora().plant(text, pats, 0.015, np.random.default_rng(19))
    allmatch = torch.full((100 * MB,), ord("a"), dtype=torch.uint8,
                          device=dev)
    counted = "compact_wordwise_chunks" in getattr(trace, "DEVICE_KEYS", ())
    for name, mt, d in (("pattern_stream_64MB", m, dense), ("text", m, text),
                        ("all_match", pt.Matcher([b"aaaa"], device=dev),
                         allmatch)):
        eng = mt._engine()
        n = d.shape[0]
        block = eng.tile_rows * 128
        mt.match_device(d)
        wordwise = None
        if counted:
            before = trace.device_counters()["compact_wordwise_chunks"]
            mt.match_device(d)
            wordwise = (trace.device_counters()["compact_wordwise_chunks"]
                        - before)
        kernels = _kernels(lambda: mt.match_device(d), reps=20)
        _, bits, counts = sieve.sieve(d, n, npad_for(n), eng._sieve)
        cases = [(False, pipeline.threshold(eng._walk, block), kernels)]
        if name == "all_match":
            cases.append((True, block + 1, _kernels(
                lambda: compact.compact(bits, counts, block + 1), reps=20)))
        for disarmed, thresh, times in cases:
            pos, cnt = compact.compact(bits, counts, thresh)
            print(json.dumps({
                "tree": tree, "compact": name, "MB": n / MB,
                "disarmed": disarmed,
                "compact_ms": next((v for k, v in times.items()
                                    if "compact_kernel" in k), None),
                "device_ms": times, "survivors": int(cnt),
                "wordwise_chunks": None if disarmed else wordwise,
                "fingerprint": _positions_fingerprint(pos, cnt),
                "clocks": _clocks()}), flush=True)
            del pos, cnt
        del bits, counts
        torch.cuda.empty_cache()


def worker(tree: str, backend: str = "sieve") -> int:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import pfac_tpu_torch as pt

    if not torch.cuda.is_available():
        print("no GPU (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    assert os.path.abspath(pt.__file__).startswith(os.path.abspath(tree))
    dev = torch.device("cuda:0")
    if backend == "xla":
        walker_worker(tree, dev)
        return 0
    if backend == "k1":
        k1_worker(tree, dev)
        return 0
    if backend == "k2":
        k2_worker(tree, dev)
        return 0
    if backend == "compact":
        compact_worker(tree, dev)
        return 0
    t0 = time.perf_counter()
    cases = corpora(pt, dev)
    print(f"worker {tree}: set-up {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, mt, host in cases:
        d = torch.from_numpy(host).to(dev)
        res = mt.match_device(d)
        fingerprint = _fingerprint(res, host.shape[0])
        ms = _ms(lambda: mt.match_device(d))
        kernels = _kernels(lambda: mt.match_device(d))
        busy = sum(kernels.values())
        print(json.dumps({"tree": tree, "corpus": name, "ms": ms,
                          "GB/s": host.shape[0] / ms / 1e6,
                          "fingerprint": fingerprint, "device_ms": kernels,
                          "busy_ms": round(busy, 4),
                          "busy_share": round(busy / ms, 4),
                          "k3_batched_ms": _k3_batched(mt, d),
                          "clocks": _clocks()}), flush=True)
        del d, res
        torch.cuda.empty_cache()
    return 0


def main(argv: list[str]) -> int:
    if len(argv) >= 3 and argv[0] == "--worker":
        return worker(argv[1], argv[2])
    backend = "sieve"
    if argv[:1] == ["--backend"] and len(argv) >= 2:
        backend, argv = argv[1], argv[2:]
    if not argv or backend not in ("sieve", "xla", "k1", "k2", "compact"):
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--worker", tree, backend]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

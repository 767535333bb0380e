"""The cell ``snort2k.virus_dense_64MB`` on the CPU at a small size: its
generator (the ruleset's patterns concatenated), a whole run that is
correct and reports its metrics, the comparison failing where the timed
path is broken and for the control, and the readers of K2's counters."""
import json
import os

import numpy as np
import pytest
import torch

from pfac_bench import control, harness, manifest
from pfac_bench.corpora import draw_until, packed
from pfac_bench.layout import Bench
from pfac_bench.tests.test_pfac_bench_harness import Broken

CPU = torch.device("cpu")
CELL = "snort2k.virus_dense_64MB"
SMALL = {"traffic": {"corpus": {"bytes": 1 << 16}, "trace_seconds": 0.5}}
#: a window long enough that both pool batches complete on a busy CPU (a
#: request on 64 KiB of pattern stream takes 0.03-1 s there)
SECONDS = 1.5
COUNTED = {"positions": 1000, "survivors": 40, "walk_steps": 400,
           "walk_slots": 640}


def _patterns(bench: Bench) -> list[bytes]:
    cfg = bench.config(bench.cell(CELL)["config"])
    return bench.module("rulesets", cfg["ruleset"]["kind"]).make(
        cfg["ruleset"])


def _stream(bench, pats, n, seed):
    make = bench.module("corpora", "pattern_stream").make
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 63)))
    return make({}, pats, n, rng, gen, CPU)


@pytest.mark.parametrize("n", [0, 1, 243, 1 << 16, (1 << 16) + 7])
def test_the_stream_is_whole_copies_then_one_cut(n):
    bench = Bench.load()
    pats = _patterns(bench)
    got = _stream(bench, pats, n, 2**33 + n)
    assert got.dtype == torch.uint8 and got.shape == (n,)
    # the same draws (after the generator's seed), spelled out pattern by
    # pattern
    _, _, lens = packed(pats)
    rng = np.random.default_rng(2**33 + n)
    rng.integers(1 << 63)
    picks = draw_until(rng, lens, n)
    if n:
        assert lens[picks[:-1]].sum() < n <= lens[picks].sum()
    assert bytes(got.tolist()) == b"".join(pats[i] for i in picks)[:n]


def test_same_seed_same_stream_other_seed_other_stream():
    bench = Bench.load()
    pats = _patterns(bench)
    a, b, c = (_stream(bench, pats, 1 << 16, s) for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def _run(factory=harness.port_matcher, trace=False, bench=None):
    return harness.run_cell(bench or Bench.load(), CELL, 2**31 + 11,
                            SECONDS, trace, CPU, matcher_factory=factory,
                            overrides=SMALL, log=lambda _m: None)


def test_small_run_is_correct_and_reports_its_metrics():
    bench = Bench.load()
    run = _run(trace=True, bench=bench)
    assert run.correct, run.checks
    assert run.window.completed > 0 and run.window.failed == 0
    line = harness.result(bench, run, False, {"platform": "cpu"})
    assert set(line["metrics"]) == {"scan_GBps", "batch_ms_p95", "setup_s"}
    traced = harness.result(bench, run, True, {"platform": "cpu"})
    # no card, no program: K2's counters have nothing to read
    assert traced["metrics"] == {}
    json.dumps(traced)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(fault):
    run = _run(factory=lambda p, d: Broken(fault, p, d))
    assert not run.correct
    assert run.checks["wrong_ids"] > 0


def test_the_control_is_not_correct():
    out = control.readings(Bench.load(), CELL, [3], [3, 4], SECONDS, CPU,
                           overrides=SMALL, emit=lambda _l: None)
    assert out["program_correct"] == [True]
    assert out["control_correct"] == [False, False]
    assert all(v == 0 for v in out["lower"].values())
    assert out["upper"]["wrong_ids"] > 0


@pytest.mark.parametrize("name,want", [("walk_steps_per_survivor", 10.0),
                                       ("walk_lane_busy_pct", 62.5)])
def test_readers_of_the_walk_counters(name, want):
    mod = Bench.load().module("metrics", name)
    assert mod.value(COUNTED) == pytest.approx(want)
    assert mod.value(None) is None                     # no registry
    # a port without K2's counters (the parent of this cell)
    assert mod.value({"positions": 1000, "survivors": 40,
                      "blocks_escaped": 0, "short_probes": 9}) is None
    # a run that built no program: every device word 0
    assert mod.value(dict.fromkeys(COUNTED, 0)) is None


def test_the_cell_is_appended_with_its_metrics():
    root = Bench.load().root
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        m = json.load(f)
    assert manifest.problems(m, root) == []
    cell = m["workloads"][-1]
    assert (cell["name"], cell["config"], cell["traffic"], cell["chips"]) == (
        CELL, "snort2k_bench2", "virus_dense_64MB", 1)
    # a configuration of its own (Benchmark II's source), appended, that
    # runs the text cells' ruleset
    config = m["configs"][-1]
    assert (config["name"], config["reduced"]) == ("snort2k_bench2", [])
    assert config["source"] not in {c["source"] for c in m["configs"][:-1]}
    bench = Bench.load()
    assert bench.config("snort2k_bench2")["ruleset"] == \
        bench.config("snort2k")["ruleset"]
    new = {x["name"]: x for x in m["per_layer"][-2:]}
    assert set(new) == {"walk_steps_per_survivor", "walk_lane_busy_pct"}
    for x in new.values():
        assert x["workloads"] == ["snort2k.text_192MB",
                                  "snort2k.text_192MB_reduce", CELL]
        assert (x["layer"], x["moves"]) == ("kernels", "scan_GBps")
    traffic = Bench.load().traffic("virus_dense_64MB")
    assert traffic["corpus"] == {"kind": "pattern_stream",
                                 "bytes": 64 << 20}
    assert len(traffic["source"]) <= 200


@pytest.mark.cuda
def test_small_cell_on_the_card_reads_the_walk_counters():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from pfac_tpu_torch import trace
    trace.reset()                   # the counters are the process's
    bench = Bench.load()
    run = harness.run_cell(bench, CELL, 2**31 + 5, 1.0, True,
                           torch.device("cuda", 0),
                           overrides={"traffic": {"corpus": {
                               "bytes": 4 << 20}}}, log=lambda _m: None)
    assert run.correct, run.checks
    got = harness.result(bench, run, True, {"platform": "gpu"})["metrics"]
    assert 8 < got["walk_steps_per_survivor"]["value"] < 13
    assert 30 < got["walk_lane_busy_pct"]["value"] <= 100

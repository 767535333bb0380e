"""The cell ``bench1_aaaa.allmatch_100MB`` on the CPU at a small size: its
generators (a ruleset given in full, one byte repeated), a whole run that
is correct, the comparison failing where the timed path leaves out the
dense-block walk's matches or shifts them, and the readers of K3's
counters. The control (walks cut at 32 bytes) is correct on this input, as
no walk here passes 4 bytes, so the faults stand in for it."""
import json
import os

import numpy as np
import pytest
import torch

from pfac_bench import control, harness, manifest
from pfac_bench.layout import Bench

CPU = torch.device("cpu")
CELL = "bench1_aaaa.allmatch_100MB"
SMALL_BYTES = 3 * 65536 + 1111
SMALL = {"traffic": {"corpus": {"bytes": SMALL_BYTES}, "trace_seconds": 0.5}}
#: a window long enough that both pool batches complete on a busy CPU
SECONDS = 1.5
COUNTED = {"positions": 4 * 65536, "launch.program": 4,
           "block_walk_positions": 3 * 65536 + 1111,
           "block_walk_probes": 2 * (3 * 65536 + 1111)}


def _patterns(bench: Bench) -> list[bytes]:
    cfg = bench.config(bench.cell(CELL)["config"])
    return bench.module("rulesets", cfg["ruleset"]["kind"]).make(
        cfg["ruleset"])


def test_the_literal_ruleset_is_its_strings_as_bytes():
    make = Bench.load().module("rulesets", "literal").make
    assert make({"patterns": ["aaaa", "abÿ", "a"]}) == [
        b"aaaa", b"ab\xff", b"a"]
    assert _patterns(Bench.load()) == [b"aaaa"]


@pytest.mark.parametrize("n", [0, 1, SMALL_BYTES])
def test_the_corpus_is_one_byte_whatever_the_seed(n):
    make = Bench.load().module("corpora", "repeat_byte").make
    got = [make({"byte": 97}, [b"aaaa"], n, np.random.default_rng(seed),
                torch.Generator().manual_seed(seed), CPU)
           for seed in (1, 2**33 + 5)]
    for t in got:
        assert t.dtype == torch.uint8 and t.shape == (n,)
        assert bytes(t.tolist()) == b"a" * n
    assert bytes(make({"byte": 98}, [], 5, None, None, CPU).tolist()) == \
        b"bbbbb"


def _run(factory=harness.port_matcher, trace=False, bench=None):
    return harness.run_cell(bench or Bench.load(), CELL, 2**31 + 13,
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
    # no card, no program: K3's counters have nothing to read
    assert traced["metrics"] == {}
    json.dumps(traced)


class Faulty:
    """The port's handle with its result broken: the matches of 4 bytes or
    more left out (what K3 writes on this input), or every ID moved one
    position on."""

    def __init__(self, fault, patterns, device):
        self.m = harness.port_matcher(patterns, device)
        self.fault = fault
        self.lens = torch.tensor([0] + [len(p) for p in patterns])

    def match_device(self, batch):
        out = self.m.match_device(batch).clone()
        if self.fault == "deep_left_out":
            out[self.lens[out.long()] >= 4] = 0
        elif self.fault == "shifted":
            out[1:] = out[:-1].clone()
            out[0] = 0
        else:
            raise ValueError(self.fault)
        return out


@pytest.mark.parametrize("fault", ["deep_left_out", "shifted"])
def test_a_broken_timed_path_is_not_correct(fault):
    run = _run(factory=lambda p, d: Faulty(fault, p, d))
    assert not run.correct
    assert run.checks["wrong_ids"] > 0


def test_the_control_is_correct_on_this_input():
    # walks cut at 32 bytes change nothing where the one pattern has 4
    out = control.readings(Bench.load(), CELL, [3], [3], SECONDS, CPU,
                           overrides=SMALL, emit=lambda _l: None)
    assert out["program_correct"] == [True]
    assert out["control_correct"] == [True]


@pytest.mark.parametrize("name,want", [
    ("escaped_pct", 100.0 * (3 * 65536 + 1111) / (4 * 65536)),
    ("block_walk_probes_per_position", 2.0)])
def test_readers_of_the_block_walk_counters(name, want):
    mod = Bench.load().module("metrics", name)
    assert mod.value(COUNTED) == pytest.approx(want)
    assert mod.value(None) is None                     # no registry
    # a port without K3's counters (the parent of this cell)
    assert mod.value({"positions": 1000, "survivors": 40,
                      "blocks_escaped": 1, "walk_steps": 9}) is None
    # a run that built no program: every device word 0
    assert mod.value(dict.fromkeys(COUNTED, 0)) is None


def test_block_walk_roofline_reads_k3s_own_time():
    mod = Bench.load().module("metrics", "block_walk_roofline")
    assert mod.least_bytes(1000) == 5000
    # 4 calls of 3 * 65536 + 1111 positions over the run; 10 traced
    # requests of K3 time 1 ms at 3.35 TB/s
    per_call = (3 * 65536 + 1111) / 4
    want = 100.0 * 5 * per_call * 10 / 3.35e12 / 1e-3
    assert mod.value(COUNTED, 10, 1e-3, 3.35e12) == pytest.approx(want)
    for c, req, s, peak in ((None, 10, 1e-3, 3.35e12),
                            ({"positions": 10, "launch.program": 1}, 10,
                             1e-3, 3.35e12),
                            (COUNTED, 0, 1e-3, 3.35e12),
                            (COUNTED, 10, 0.0, 3.35e12),
                            (COUNTED, 10, 1e-3, None)):
        assert mod.value(c, req, s, peak) is None


def test_block_walk_roofline_sums_the_kernels_ops(monkeypatch):
    # the ops whose names start with block_walk_kernel, whatever their
    # template argument; a run without a trace reads nothing
    from pfac_bench import counters, devtrace, harness as h
    mod = Bench.load().module("metrics", "block_walk_roofline")
    monkeypatch.setattr(counters, "read", lambda: COUNTED)
    trace = devtrace.TraceSummary(
        window_s=0.5, busy_s=0.4, device_ops=[
            ("sieve_smem_kernel", 0.2), ("block_walk_kernel<true>", 0.1),
            ("block_walk_kernel<false>", 0.05), ("walk_kernel<true>", 0.01)],
        idle_gaps=[], device_events=10)
    win = h.Window(latency_ms=[1.0] * 10)
    run = h.Run(cell=CELL, setup_s=1.0, engine_build_s=1.0, window=win,
                traced=win, trace=trace, peak_bytes_per_s=3.35e12,
                memory_peak_bytes=None, checks={}, limits={})
    assert mod.read(run) == pytest.approx(mod.value(COUNTED, 10, 0.15,
                                                    3.35e12))
    run.trace = None
    assert mod.read(run) is None


def test_the_cell_is_appended_with_its_metrics():
    root = Bench.load().root
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        m = json.load(f)
    assert manifest.problems(m, root) == []
    cell = m["workloads"][-1]
    assert (cell["name"], cell["config"], cell["traffic"], cell["chips"]) == (
        CELL, "bench1_aaaa", "allmatch_100MB", 1)
    config = m["configs"][-1]
    assert (config["name"], config["reduced"]) == ("bench1_aaaa", [])
    assert config["source"] not in {c["source"] for c in m["configs"][:-1]}
    assert Bench.load().config("bench1_aaaa")["reduced"] == []
    new = {x["name"]: x for x in m["per_layer"][-3:]}
    assert set(new) == {"escaped_pct", "block_walk_probes_per_position",
                        "block_walk_roofline"}
    for x in new.values():
        assert x["workloads"] == [CELL]
        assert (x["layer"], x["moves"]) == ("kernels", "scan_GBps")
    traffic = Bench.load().traffic("allmatch_100MB")
    assert traffic["corpus"] == {"kind": "repeat_byte", "bytes": 100 << 20,
                                 "byte": 97}
    assert (traffic["op"], traffic["pool"], traffic["in_flight"]) == (
        "match_device", 2, 1)
    assert len(traffic["source"]) <= 200


@pytest.mark.cuda
def test_small_cell_on_the_card_reads_the_block_walk_counters():
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
    assert got["escaped_pct"]["value"] == 100.0
    assert got["block_walk_probes_per_position"]["value"] == 1.0
    assert 0 < got["block_walk_roofline"]["value"] <= 105

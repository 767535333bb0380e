"""Whole runs on the CPU at a small size: the harness's look for a card is
skipped, the rest of a run is driven (set-up, window, check, result line),
and the comparison is shown to fail where the timed path is broken and for
the control."""
import json
import os

import numpy as np
import pytest
import torch

from pfac_bench import control, harness
from pfac_bench.layout import Bench

CPU = torch.device("cpu")
SNORT = "snort2k.text_192MB"
REDUCE = "snort2k.text_192MB_reduce"
SMALL = {
    cell: {"traffic": {"corpus": {"bytes": 1 << 16}, "trace_seconds": 0.2}}
    for cell in (SNORT, REDUCE)
}


def _run(cell, seed=2**31 + 7, factory=harness.port_matcher, trace=False,
         bench=None, overrides=None):
    return harness.run_cell(bench or Bench.load(), cell, seed, 0.3, trace,
                            CPU, matcher_factory=factory,
                            overrides=overrides or SMALL[cell],
                            log=lambda _m: None)


@pytest.mark.parametrize("cell", [SNORT, REDUCE])
def test_small_run_is_correct_and_reports_its_metrics(cell):
    bench = Bench.load()
    run = _run(cell, trace=True, bench=bench)
    assert run.correct, run.checks
    assert run.window.completed > 0 and run.window.failed == 0
    line = harness.result(bench, run, False, {"platform": "cpu"})
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"scan_GBps", "batch_ms_p95", "setup_s"}
    assert line["attempted"] == run.window.completed
    traced = harness.result(bench, run, True, {"platform": "cpu"})
    # no card: the device's metrics have nothing to read and are left out
    assert set(traced["metrics"]) == {"engine_build_s", "host_call_us"}
    json.dumps(traced)


def test_same_seed_same_batches_other_seed_other_batches():
    bench = Bench.load()
    cfg = bench.config("snort2k")
    pats = bench.module("rulesets", "snort_like").make(cfg["ruleset"])
    make = bench.module("corpora", "planted_text").make

    def batch(seed):
        rng = np.random.default_rng(seed)
        gen = torch.Generator().manual_seed(int(rng.integers(1 << 63)))
        return make({"planted_share": 0.015}, pats, 1 << 16, rng, gen, CPU)

    assert torch.equal(batch(5), batch(5))
    assert not torch.equal(batch(5), batch(6))


def test_planted_copies_are_whole_and_apart():
    pats = [b"0123456789", b"ABCDE", b"xyz"]
    make = Bench.load().module("corpora", "planted_text").make
    rng = np.random.default_rng(1)
    buf = make({"planted_share": 0.3, "low": 97, "high": 100}, pats, 4000,
               rng, torch.Generator().manual_seed(1), CPU)
    text = bytes(buf.tolist())
    planted = sum(len(p) * text.count(p) for p in pats)
    assert 0.3 * 4000 <= planted <= 0.3 * 4000 + 10


class Broken:
    """The port's handle with the timed path broken underneath."""

    def __init__(self, fault, patterns, device):
        self.m = harness.port_matcher(patterns, device)
        self.fault, self.first = fault, None

    def _break(self, out, batch, reduce):
        if self.fault == "unchanged":        # the state never moves on
            if self.first is None:
                self.first = out
            return self.first
        if self.fault == "half":             # half of the batch left out
            half = batch.numel() // 2
            if reduce:
                return self.m.match_reduce_device(batch[:half])
            out = out.clone()
            out[half:] = 0
            return out
        if self.fault == "altered":          # an answer altered
            if reduce:
                ids = out[0].clone()
                ids[0] += 1
                return ids, out[1], out[2]
            out = out.clone()
            at = int(torch.nonzero(out)[0])
            out[at] += 1
            return out
        raise ValueError(self.fault)

    def match_device(self, batch):
        return self._break(self.m.match_device(batch), batch, False)

    def match_reduce_device(self, batch):
        return self._break(self.m.match_reduce_device(batch), batch, True)


@pytest.mark.parametrize("cell", [SNORT, REDUCE])
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    run = _run(cell, factory=lambda p, d: Broken(fault, p, d))
    assert not run.correct
    assert sum(run.checks.values()) > 0


@pytest.mark.parametrize("cell", [SNORT, REDUCE])
def test_the_control_is_not_correct(cell):
    """The reference with its walks cut at control.CAP bytes, in the
    program's place, fails the comparison; the program on the same seeds
    passes it."""
    out = control.readings(Bench.load(), cell, [3], [3, 4], 0.2, CPU,
                           overrides=SMALL[cell], emit=lambda _l: None)
    assert out["program_correct"] == [True]
    assert out["control_correct"] == [False, False]
    assert all(v == 0 for v in out["lower"].values())
    wrong = ("wrong_ids",) if cell == SNORT else ("count_gap", "wrong_pairs")
    assert sum(out["upper"][k] for k in wrong) > 0


def test_a_new_config_mix_and_metric_are_files_only(tmp_path):
    """A throwaway configuration, traffic mix, ruleset generator, corpus
    generator and metric, each a new file in a directory of its own, run
    with no edit to the harness."""
    for d in ("configs", "traffic", "metrics", "rulesets", "corpora"):
        (tmp_path / d).mkdir()
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(
        {"ruleset": {"kind": "listed", "patterns": ["aaaa", "ab"]},
         "reduced": []}))
    (tmp_path / "rulesets" / "listed.py").write_text(
        "def make(params):\n"
        "    return [p.encode('latin-1') for p in params['patterns']]\n")
    (tmp_path / "traffic" / "all_a.json").write_text(json.dumps(
        {"op": "match_reduce_device", "pool": 3, "in_flight": 2,
         "corpus": {"kind": "one_byte", "bytes": 1000, "byte": 97}}))
    (tmp_path / "corpora" / "one_byte.py").write_text(
        "import torch\n"
        "def make(params, patterns, n, rng, gen, device):\n"
        "    return torch.full((n,), params['byte'], dtype=torch.uint8,\n"
        "                      device=device)\n")
    (tmp_path / "metrics" / "requests.done.py").write_text(
        "def read(run):\n    return float(run.window.completed)\n")
    m = {"workloads": [{"name": "tiny.all_a", "config": "tiny",
                        "traffic": "all_a", "chips": 1, "why": "test"}],
         "configs": [{"name": "tiny", "file": str(tmp_path / "configs" /
                                                  "tiny.json")}],
         "end_to_end": [{"name": "requests.done", "unit": "1"},
                        {"name": "setup_s", "unit": "s"}],
         "per_layer": []}
    bench = Bench(m, root=str(tmp_path), search=[str(tmp_path)])
    run = harness.run_cell(bench, "tiny.all_a", 1, 0.3, False, CPU,
                           log=lambda _m: None)
    assert run.correct, run.checks
    assert set(run.window.nbytes) == {1000}
    line = harness.result(bench, run, False, {"platform": "cpu"})
    assert line["metrics"]["requests.done"]["value"] == run.window.completed
    assert "setup_s" in line["metrics"]


def test_cli_exits_without_a_result_where_no_card(tmp_path):
    import subprocess
    import sys
    root = Bench.load().root
    res = subprocess.run(
        [sys.executable, os.path.join(root, "pfac_bench", "run.py"),
         "--workload", SNORT, "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=str(tmp_path),
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "needs 1 CUDA device" in res.stderr


class WritesPast(Broken):
    """Writes a nonzero word past the result: past n (the padded tail of
    ``match_device``) or past the count (``match_reduce_device``)."""

    def match_device(self, batch):
        out = self.m.match_device(batch).clone()
        out[batch.numel():] = 1
        return out

    def match_reduce_device(self, batch):
        ids, pos, count = self.m.match_reduce_device(batch)
        ids = ids.clone()
        ids[int(count)] = 1
        return ids, pos, count


@pytest.mark.parametrize("cell,number", [(SNORT, "tail_nonzero"),
                                         (REDUCE, "past_count_nonzero")])
def test_a_write_past_the_result_is_not_correct(cell, number):
    """At the cells' own sizes the batch fills whole 64 Ki-position buckets,
    so no padding exists; at n = 65,536 + 100 it does, and a write there
    reads on its own number."""
    over = harness._merge(SMALL[cell], {"traffic": {"corpus": {
        "bytes": (1 << 16) + 100}}})
    run = _run(cell, overrides=over)
    assert run.correct, (run.checks, run.window.completed)
    run = _run(cell, overrides=over,
               factory=lambda p, d: WritesPast("none", p, d))
    assert not run.correct
    assert run.checks[number] > 0, run.checks
    assert sum(v for k, v in run.checks.items() if k != number) == 0, \
        (run.checks, run.window.completed)

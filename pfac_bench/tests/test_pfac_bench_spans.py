"""The readers of the program's own spans and counters, and the per-request
records and idle split of ``spans.py``, on hand-made trace events and
counters."""
import sys
import types

import pytest

from pfac_bench import counters, spans
from pfac_bench.layout import Bench

US = 1e-6


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _request(t, corr):
    """A request at t us: the host wakes at t + 20 from the last wait,
    enters the handle at t + 40; the program zeroes its words (memset,
    corr) and launches the graph (corr + 1), whose K1 runs from t + 90."""
    return [
        _x("pfac.match_device", "cpu_op", t + 40, 60),
        _x("pfac.sieve_engine", "cpu_op", t + 45, 50),
        _x("pfac.program", "cpu_op", t + 50, 40),
        _x("aten::empty", "cpu_op", t + 52, 3),
        _x("cudaMemsetAsync", "cuda_runtime", t + 60, 5, corr),
        _x("Memset (Device)", "gpu_memset", t + 68, 2, corr),
        _x("cudaGraphLaunch", "cuda_runtime", t + 75, 10, corr + 1),
        _x("void sieve_smem_kernel(int)", "kernel", t + 90, 400, corr + 1),
        _x("walk_kernel", "kernel", t + 490, 100, corr + 1),
        _x("cudaEventSynchronize", "cuda_runtime", t + 100, 520),
        _x("aten::copy_", "cpu_op", t + 30, 5),   # the harness's own op
    ]


def _trace():
    # the window from 0 to 1300 us: requests at 0 and 600 (the second's
    # gap starts when the first's last kernel ends, at 590)
    return ([_x("pfac_bench.window", "user_annotation", 0, 1300)]
            + _request(0, 10) + _request(600, 20))


def test_one_record_a_request():
    recs = spans.requests(_trace())
    assert [r["name"] for r in recs] == ["pfac.match_device"] * 2
    r = recs[1]
    assert r["start"] == pytest.approx(640 * US)
    assert r["end"] == pytest.approx(700 * US)
    assert r["first_k1"] == pytest.approx(690 * US)
    assert r["self"] == pytest.approx({"pfac.match_device": 10 * US,
                                       "pfac.sieve_engine": 10 * US,
                                       "pfac.program": 40 * US})
    assert r["runtime"] == pytest.approx({"cudaMemsetAsync": 5 * US,
                                          "cudaGraphLaunch": 10 * US})
    m = spans.means(recs)
    assert m["requests"] == 2
    assert m["call_us"] == pytest.approx(60)
    assert m["dispatch_us"] == pytest.approx(50)


def test_idle_split_by_the_host_state():
    lo, hi = 0.0, 1300 * US
    split = spans.idle_split(_trace(), lo, hi)
    want_us = {
        # [0, 68) before the first memset, [70, 90) before K1, for each
        # request; the second's gap opens at 590, inside the first's wait,
        # which returns at 620; the window's last gap opens at 1190
        "unattributed": 1300 - 1190,
        "wait": 620 - 590,
        "harness": 40 + 20,
        "pfac.match_device": 5 + 5,
        "pfac.sieve_engine": 5 + 5,
        "pfac.program": 2 * (7 + 5),
        "aten::empty": 2 * 3,                     # an op the program calls
        "cudaMemsetAsync": 2 * 5,
        "cudaGraphLaunch": 2 * 10,
        "launch latency": 2 * (3 + 5),
    }
    got_us = {k: v / US for k, v in split.items()}
    assert got_us == pytest.approx(want_us)
    assert sum(split.values()) == pytest.approx(
        1300 * US - 2 * (2 + 500) * US)
    s = spans.summary(_trace())
    assert s["requests"] == 2 and s["idle_split_us_a_request"][
        "launch latency"] == pytest.approx(8)


def test_launch_lags_show_a_card_clock_ahead_of_the_host():
    ev = _trace()
    # memset 3 us and K1 5 us after their calls' ends: 8 and 15 us after
    # their starts, in each request
    assert [round(x / US, 6) for x in spans.lags(ev)] == [8, 8, 15, 15]
    assert spans.summary(ev)["lag_us"]["negative"] == 0
    skewed = [dict(e, ts=e["ts"] - 50) if e["cat"] in ("kernel", "gpu_memset")
              else e for e in ev]
    lag = spans.summary(skewed)["lag_us"]
    assert lag["min"] == pytest.approx(-42) and lag["negative"] == 4


def test_no_window_or_no_request():
    assert spans.summary(_request(0, 1)) == {}
    assert spans.means([]) == {"requests": 0}


COUNTED = {
    "span.pfac.match_device.calls": 3, "span.pfac.match_device.s": 150e-6,
    "span.pfac.match_reduce_device.calls": 1,
    "span.pfac.match_reduce_device.s": 90e-6,
    "span.pfac.sieve_engine.calls": 4, "span.pfac.sieve_engine.s": 1.0,
    "positions": 4 * 65536, "survivors": 8192, "blocks_escaped": 1,
    "build.automaton_s": 0.5, "build.tables_s": 1.25, "build.upload_s": 0.25,
    "build.library_s": 0.5, "build.program_s": 0.5, "build.programs": 2,
    "launch.walk_kernel": 4,
}


@pytest.mark.parametrize("name,want", [
    ("call_span_us", 60.0), ("survivor_pct", 3.125),
    ("handle_build_s", 3.0)])
def test_readers_of_the_program_counters(name, want):
    mod = Bench.load().module("metrics", name)
    assert mod.value(COUNTED) == pytest.approx(want)
    assert mod.value(None) is None                # no registry: left out
    assert mod.value({"launch.walk_kernel": 4}) is None  # nothing it reads


@pytest.mark.parametrize("name", ["call_span_us", "handle_build_s"])
def test_readers_leave_out_a_run_that_built_no_program(name):
    # the CPU path: spans and host build seconds, but no card program
    cpu = {k: v for k, v in COUNTED.items() if k != "build.programs"}
    assert Bench.load().module("metrics", name).value(cpu) is None


def test_counters_read_the_registry_only_where_loaded(monkeypatch):
    monkeypatch.delitem(sys.modules, counters.REGISTRY, raising=False)
    assert counters.read() is None
    for name in ("call_span_us", "survivor_pct", "handle_build_s"):
        assert Bench.load().module("metrics", name).read(None) is None
    fake = types.ModuleType(counters.REGISTRY)
    fake.counters = lambda: {"positions": 100}
    fake.device_counters = lambda: {"survivors": 7, "blocks_escaped": 0}
    monkeypatch.setitem(sys.modules, counters.REGISTRY, fake)
    assert counters.read() == {"positions": 100, "survivors": 7,
                               "blocks_escaped": 0}
    assert Bench.load().module("metrics", "survivor_pct").read(None) == 7.0

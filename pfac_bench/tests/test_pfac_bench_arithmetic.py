"""The yardstick's own arithmetic: bytes an operation needs, the metrics
from a request log and from profiler intervals, and the manifest's rules."""
import json
import os
import types

import pytest

from pfac_bench import devtrace, manifest
from pfac_bench.harness import Window
from pfac_bench.layout import ROOT, Bench


def _read(name: str, run) -> float | None:
    return Bench.load().module("metrics", name).read(run)


def _bytes(op: str):
    return Bench.load().module("bytecount", op).least_bytes


def test_byte_counts():
    assert _bytes("match_device")(192 << 20, None) == 5 * (192 << 20)
    assert _bytes("match_device")(192 << 20, 7) == 1_006_632_960
    assert _bytes("match_reduce_device")(64 << 20, 1000) == \
        (64 << 20) + 8000 + 4
    with pytest.raises(ValueError):
        _bytes("match_reduce_device")(10, None)


def _run(window=None, trace=None, traced=None, peak=None, **kw):
    return types.SimpleNamespace(window=window or Window(), trace=trace,
                                 traced=traced, peak_bytes_per_s=peak,
                                 setup_s=kw.get("setup_s"),
                                 engine_build_s=kw.get("engine_build_s"))


def _log(lat_ms: list[float], nbytes: int) -> Window:
    w = Window(latency_ms=list(lat_ms), call_s=[25e-6] * len(lat_ms),
               nbytes=[nbytes] * len(lat_ms))
    w.seconds = sum(lat_ms) / 1e3
    return w


def test_scan_rate_and_tail_from_a_request_log():
    steady = _log([1.0] * 1000, 10**6)
    assert _read("scan_GBps", _run(steady)) == pytest.approx(1.0)
    assert _read("batch_ms_p95", _run(steady)) == pytest.approx(1.0)
    assert _read("host_call_us", _run(steady)) == pytest.approx(25.0)
    # a stall of 20 ms in 10% of the requests moves both
    stalled = _log([1.0] * 900 + [20.0] * 100, 10**6)
    assert _read("scan_GBps", _run(stalled)) < 0.5
    assert _read("batch_ms_p95", _run(stalled)) == pytest.approx(20.0)
    assert _read("scan_GBps", _run(Window())) is None
    assert _read("batch_ms_p95", _run(Window())) is None


def test_setup_and_engine_build_read_the_run():
    r = _run(setup_s=12.5, engine_build_s=3.25)
    assert _read("setup_s", r) == 12.5
    assert _read("engine_build_s", r) == 3.25


def test_intervals_union_busy_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (2.0, 2.5), (3.0, 4.0), (3.2, 3.4),
          (9.0, 8.0)]
    assert devtrace.union(iv) == [(0.0, 2.5), (3.0, 4.0)]
    assert devtrace.busy(iv, 0.0, 5.0) == pytest.approx(3.5)
    assert devtrace.busy(iv, 1.0, 3.5) == pytest.approx(2.0)
    assert devtrace.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.5, 3.0),
                                            (4.0, 5.0)]
    assert devtrace.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_idle_gaps_labelled_by_host_op():
    idle = [(0.0, 1.0), (2.0, 3.0), (5.0, 6.0)]
    spans = [(0.5, 2.5, "cudaEventSynchronize"), (0.9, 1.0, "inner"),
             (2.1, 2.2, "aten::empty"), (-10.0, 100.0, "outer")]
    got = devtrace.label_gaps(idle, spans)
    assert got == {"outer": 3.0}
    got = devtrace.label_gaps(idle, spans[:3])
    assert got == {"cudaEventSynchronize": 2.0, devtrace.PYTHON: 1.0}


def _trace_events(kernels, window=(0.0, 1.0), host=()):
    us = 1e6
    ev = [{"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW,
           "ts": window[0] * us, "dur": (window[1] - window[0]) * us},
          {"ph": "X", "cat": "gpu_user_annotation", "name": devtrace.WINDOW,
           "ts": window[0] * us, "dur": 10 * us}]
    for name, a, b in kernels:
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": a * us,
                   "dur": (b - a) * us})
    for name, a, b in host:
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": name,
                   "ts": a * us, "dur": (b - a) * us})
    return ev


def test_roofline_and_idle_from_overlapping_intervals():
    ev = _trace_events(
        [("void (anonymous namespace)::k1<false>(int*)", 0.0, 0.4),
         ("(anonymous namespace)::k2(int)", 0.3, 0.5),  # overlaps k1
         ("(anonymous namespace)::k2(int)", 0.7, 0.8),
         ("k3", 0.95, 1.2)],                              # cut at 1.0
        host=[("cudaEventSynchronize", 0.5, 0.6),
              ("cudaGraphLaunch", 0.62, 0.7)])
    t = devtrace.summarize(ev)
    assert t.window_s == pytest.approx(1.0)
    assert t.busy_s == pytest.approx(0.5 + 0.1 + 0.05)
    assert dict(t.device_ops) == pytest.approx(
        {"k1<false>": 0.4, "k2": 0.3, "k3": 0.05})
    # a gap goes whole to the host op that overlaps it most
    assert dict(t.idle_gaps) == pytest.approx(
        {"cudaEventSynchronize": 0.2, devtrace.PYTHON: 0.15})
    traced = Window(latency_ms=[0.3, 0.3],
                    least_bytes=[int(3.35e9 * 0.65 / 2)] * 2)
    r = _run(trace=t, traced=traced, peak=3.35e12)
    # 0.65 ms of least time against 0.65 s of busy time
    assert _read("kernels_roofline", r) == pytest.approx(0.1)
    assert _read("device_idle_pct", r) == pytest.approx(35.0)
    assert _read("kernels_roofline", _run(trace=t, traced=traced)) is None
    assert _read("device_idle_pct", _run()) is None


def test_trace_without_device_activity_reads_nothing():
    assert devtrace.summarize(_trace_events([])) is None
    assert devtrace.summarize(_trace_events([("k", 2.0, 3.0)])) is None
    assert devtrace.summarize([]) is None


@pytest.mark.parametrize("name,ok", [
    ("scan_GBps", True), ("snort2k.text_192MB", True), ("_x-1.2", True),
    ("a" * 64, True), ("a" * 65, False), ("has space", False),
    ("a/b", False), (".lead", False), ("a,b", False), ("µs", False)])
def test_name_rule(name, ok):
    assert bool(manifest.NAME.fullmatch(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("GB/s", True), ("%", True), ("us", True), ("tokens/s", True),
    ("a" * 16, True), ("a" * 17, False), ("GB per s", False), ("µs", False),
    ("", False)])
def test_unit_rule(unit, ok):
    assert bool(manifest.UNIT.fullmatch(unit)) is ok


def _manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_committed_manifest_keeps_the_rules():
    m = _manifest()
    assert manifest.problems(m, ROOT) == []
    assert [w["name"] for w in m["workloads"]] == [
        "snort2k.text_192MB", "snort2k.text_192MB_reduce"]
    assert {x["name"] for x in m["end_to_end"]} == {
        "scan_GBps", "batch_ms_p95", "setup_s"}
    bench = Bench.load()
    for w in m["workloads"]:
        cfg = bench.config(w["config"])
        assert cfg["reduced"] == next(
            c["reduced"] for c in m["configs"] if c["name"] == w["config"])
        bench.traffic(w["traffic"])
    for x in m["end_to_end"] + m["per_layer"]:
        assert callable(bench.module("metrics", x["name"]).read)


def test_manifest_rules_catch_breaches():
    m = _manifest()
    m["end_to_end"][0]["bound"] = 0.3
    m["per_layer"][0]["moves"] = "nothing"
    m["workloads"][0]["chips"] = 2
    m["run_seconds"] = 52
    m["per_layer"][1]["why"] = "not a key"
    got = " | ".join(manifest.problems(m))
    for part in ("bound 0.3", "moves 'nothing'", "chips", "run_seconds",
                 "metric keys"):
        assert part in got
    assert manifest.check_seconds(51) <= manifest.CHECK_SECONDS
    assert manifest.check_seconds(52) > manifest.CHECK_SECONDS

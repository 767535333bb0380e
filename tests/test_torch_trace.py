"""The port's spans and counters (``pfac_tpu_torch/trace.py``) on the CPU:
spans cost a flag read with the profiler off and nest in its trace with
it on; the registry counts, expands a program's calls into its kernels'
launches and resets; a CPU pipeline launches no kernel. The card's side
(the graph's kernels under ``pfac.program``, the device counters against a
host recount) is in ``test_torch_cuda.py``."""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pfac_tpu_torch as pt
from pfac_tpu_torch import trace
from pfac_tpu_torch.backends import compact, program, reduce, sieve

README = [b"AB", b"ABG", b"BEDE", b"ED"]


@pytest.fixture(autouse=True)
def _fresh():
    trace.reset()
    yield
    trace.reset()


def _events(prof, tmp_path) -> list[dict]:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _spans(events, name) -> list[tuple[float, float]]:
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("name") == name and e.get("ph") == "X"
            and e.get("cat") == "cpu_op"]


def test_span_is_a_shared_no_op_without_the_profiler():
    assert not trace.recording()
    assert trace.span("pfac.a") is trace.span("pfac.b")
    with trace.span("pfac.a") as got:
        assert got is None

    @trace.spanned("pfac.f")
    def f(x, *, y=1):
        """f's own docstring"""
        return x + y

    assert f(1, y=2) == 3 and f.__doc__ == "f's own docstring"
    assert not [k for k in trace.counters() if k.startswith("span.")]


def test_matcher_call_nests_its_spans_in_the_profiler_trace(tmp_path):
    m = pt.Matcher(README, device="cpu")
    data = torch.frombuffer(bytearray(b"ABEDEDABG"), dtype=torch.uint8)
    m.match_device(data)                          # the engine built
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.recording()
        got = m.match_device(data)
        ids, pos, count = m.match_reduce_device(data)
    assert not trace.recording()
    assert got[:9].tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]
    assert int(count) == 5
    ev = _events(prof, tmp_path)
    outer = _spans(ev, "pfac.match_device")
    outer_r = _spans(ev, "pfac.match_reduce_device")
    inner = _spans(ev, "pfac.sieve_engine")
    assert len(outer) == len(outer_r) == 1 and len(inner) == 2
    (a0, a1), (r0, r1) = outer[0], outer_r[0]
    assert a1 <= r0                               # one request, then the next
    for lo, hi in (outer[0], outer_r[0]):
        assert sum(lo <= b0 and b1 <= hi for b0, b1 in inner) == 1
    c = trace.counters()
    assert c["span.pfac.match_device.calls"] == 1
    assert c["span.pfac.match_reduce_device.calls"] == 1
    assert c["span.pfac.sieve_engine.calls"] == 2
    assert 0 < c["span.pfac.sieve_engine.s"]
    # the outer span holds the inner one, on the host clock too
    assert (c["span.pfac.sieve_engine.s"]
            <= c["span.pfac.match_device.s"]
            + c["span.pfac.match_reduce_device.s"])


def test_a_raising_call_closes_its_span(tmp_path):
    @trace.spanned("pfac.raises")
    def boom():
        raise ValueError("no")

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            boom()
        with pytest.raises(KeyError):
            with trace.span("pfac.block"):
                raise KeyError("x")
    ev = _events(prof, tmp_path)
    assert len(_spans(ev, "pfac.raises")) == len(_spans(ev, "pfac.block")) \
        == 1
    assert trace.counters()["span.pfac.raises.calls"] == 1


def test_counters_count_time_and_reset():
    trace.count("launch.sieve_smem_kernel")
    trace.count("launch.sieve_smem_kernel", 2)
    with trace.timed("build.tables_s"):
        pass
    t = trace.tally({"launch.walk_kernel": 2, "positions": 65536})
    assert trace.tally({"positions": 65536, "launch.walk_kernel": 2}) is t
    t.calls += 3
    c = trace.counters()
    assert c["launch.sieve_smem_kernel"] == 3
    assert c["launch.walk_kernel"] == 6 and c["positions"] == 3 * 65536
    assert c["build.tables_s"] >= 0 and "build.tables_s" in c
    assert c["launch.never_launched"] == 0        # a missing key reads 0
    assert trace.launches("sieve_smem_kernel", "walk_kernel") == {
        "sieve_smem_kernel": 3, "walk_kernel": 6}
    trace.reset()
    assert not any(trace.counters().values()) and t.calls == 0
    assert trace.device_counters() == {"survivors": 0, "blocks_escaped": 0,
                                       "short_probes": 0, "walk_steps": 0,
                                       "walk_slots": 0,
                                       "block_walk_probes": 0,
                                       "block_walk_positions": 0,
                                       "compact_wordwise_chunks": 0}


def test_handle_counters_read_the_set_up():
    m = pt.Matcher(README, device="cpu")
    m.match_device(torch.zeros(70_000, dtype=torch.uint8))
    c = m.counters()
    assert c["build.automaton_s"] > 0 and c["build.tables_s"] > 0
    assert "build.upload_s" in c
    assert c["survivors"] == c["blocks_escaped"] == 0
    assert c["build.programs"] == c["positions"] == 0   # no program on a CPU


def test_cpu_pipeline_launches_no_kernel():
    # the kernels' wrappers count only where a kernel runs: the CPU path
    # runs their plain versions
    rng = np.random.default_rng(3)
    pats = [bytes(rng.integers(97, 101, size=int(k), dtype=np.uint8))
            for k in rng.integers(1, 9, size=40)]
    m = pt.Matcher(pats, device="cpu")
    data = torch.from_numpy(rng.integers(97, 101, size=300_000,
                                         dtype=np.uint8))
    m.match_device(data)
    m.match_reduce_device(data)
    assert not [k for k, v in trace.counters().items()
                if k.startswith("launch.") and v]


@pytest.fixture
def card(monkeypatch):
    """A CUDA device of 132 SMs, as K3's plan reads it."""

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shards,red,cnt", [(1, False, False),
                                            (1, True, False),
                                            (3, False, True)])
def test_program_calls_expand_into_each_launch(card, shards, red, cnt):
    # a program counts its calls once; the registry expands them into the
    # launches each call makes, as counting each launch one by one would
    # (the tier's kernels once a shard, the reduce's and the count once,
    # the program once) and the positions it scanned
    eng = pt.Matcher(README, device="cpu")._engine()
    npad = 2 * sieve.BLOCK
    geo = program.geometry(eng._sieve, eng._walk, eng._csr, npad,
                           sieve.BLOCK, card, shards=shards, reduce=red,
                           count=cnt)
    prog = program.Program(geo, eng._sieve, eng._walk, eng._csr, card)
    assert geo.tier == "walk"
    want = dict.fromkeys(sieve.KERNELS + compact.KERNELS + reduce.KERNELS
                        + ("walk_kernel", "block_walk_kernel",
                           "csr_walk_kernel", "count_kernel", "program"), 0)
    for _ in range(5):
        prog._counted(0)
        # one call's launches, counted one by one
        want[f"sieve_{geo.placement}_kernel"] += shards
        for k in compact.KERNELS + ("walk_kernel", "block_walk_kernel"):
            want[k] += shards
        for k in reduce.KERNELS if red else ():
            want[k] += 1
        want["count_kernel"] += int(cnt)
        want["program"] += 1
    assert trace.launches(*want) == want
    assert trace.counters()["positions"] == 5 * shards * npad
    with pytest.raises(RuntimeError):
        prog._counted(2)                          # counted, then raises
    assert trace.launches("program") == {"program": 6}

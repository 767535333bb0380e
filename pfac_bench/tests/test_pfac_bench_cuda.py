"""The benchmark on the card at a small size (marked ``cuda``; each test
skips inside itself where there is no card): both cells' timed paths
correct against the reference, the device's metrics read from the trace,
and the control failing there too."""
import pytest
import torch

from pfac_bench import control, harness
from pfac_bench.layout import Bench

SMALL = {cell: {"traffic": {"corpus": {"bytes": 4 << 20}}}
         for cell in ("snort2k.text_192MB", "snort2k.text_192MB_reduce")}


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_small_cell_on_the_card(cell):
    dev = _card()
    bench = Bench.load()
    run = harness.run_cell(bench, cell, 2**31 + 3, 1.0, True, dev,
                           overrides=SMALL[cell], log=lambda _m: None)
    assert run.correct, run.checks
    assert run.trace is not None and run.trace.busy_s > 0
    line = harness.result(bench, run, True, {"platform": "gpu"})
    assert {"kernels_roofline", "device_idle_pct"} <= set(line["metrics"])
    assert 0 < line["metrics"]["kernels_roofline"]["value"] <= 100


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_on_the_card(cell):
    dev = _card()
    out = control.readings(Bench.load(), cell, [1], [2], 0.5, dev,
                           overrides=SMALL[cell], emit=lambda _l: None)
    assert out["program_correct"] == [True]
    assert out["control_correct"] == [False]

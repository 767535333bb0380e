"""The port's on-device fuzz (``pfac_tpu_torch.tools.device_fuzz``): its
case generator gives the reference's rulesets and corpora for a seed, and
its main loop runs on the CPU (the kernels' plain versions)."""
import numpy as np
import pytest

from pfac_tpu.tools import device_fuzz as ref_fuzz
from pfac_tpu_torch.tools import device_fuzz


@pytest.mark.parametrize("kind", ["plain", "heavy", "wide", "allmatch"])
def test_random_case_equals_reference(kind):
    flags = {k: kind == k for k in ("heavy", "wide", "allmatch")}
    for seed in (0, 1):
        got = device_fuzz._random_case(np.random.default_rng(seed), **flags)
        want = ref_fuzz._random_case(np.random.default_rng(seed), **flags)
        assert got == want


def test_schedule_equals_reference():
    # the kinds of the reference's schedule, case by case
    class Args:
        kind, heavy = None, False
    kinds = [device_fuzz._kind(c, Args) for c in range(40)]
    assert kinds[3] == "wide" and kinds[4] == "heavy" and kinds[5] == "allmatch"
    for c, k in enumerate(kinds):
        heavy = c % 5 == 4
        wide = not heavy and c % 7 == 3
        allmatch = not heavy and not wide and c % 9 == 5
        assert k == ("heavy" if heavy else "wide" if wide
                     else "allmatch" if allmatch else "plain")


def test_two_cases_on_cpu(capsys):
    assert device_fuzz.main(["--cases", "2", "--seed", "3", "--device",
                             "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count(": ok plain") == 2 and "all cases passed" in out


def test_sharded_is_refused(capsys):
    """The name stays; the refusal went with distribution's port:
    ``--sharded --device cpu`` holds the sharded matcher's match and
    match_reduce on three CPU shards equal to the golden model, a case of
    each kind."""
    for kind in ("plain", "wide"):
        assert device_fuzz.main(["--cases", "1", "--seed", "3", "--kind",
                                 kind, "--device", "cpu", "--sharded",
                                 "--shards", "3"]) == 0
        out = capsys.readouterr().out
        assert f": ok {kind}" in out and "all cases passed" in out

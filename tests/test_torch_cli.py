"""The port's CLI (``pfac_tpu_torch.tools.cli``) on the CPU: the
counterparts of ``tests/test_cli.py``, each output equal to the reference
CLI's on the same flags, and the port's own flags (``--device``,
``--sharded``, ``profile`` with ``--trace``)."""
import json
import os

import pytest

from pfac_tpu.tools import cli as ref_cli
from pfac_tpu_torch.tools import cli


@pytest.fixture()
def files(fixtures_dir):
    return (os.path.join(fixtures_dir, "pattern", "example_pattern"),
            os.path.join(fixtures_dir, "data", "example_input"))


def _both(argv, capsys):
    """-> the port's stdout, after checking both CLIs exit 0 and print the
    same."""
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert ref_cli.main(argv) == 0
    assert out == capsys.readouterr().out
    return out


class TestCliMatch:
    def test_match_prints_reference_output(self, files, capsys):
        pat, inp = files
        out = _both(["match", "-P", pat, "-I", inp, "--platform", "cpu"],
                    capsys)
        assert "num_matched = 5" in out
        assert "At position    0, match pattern 1" in out
        assert "At position    6, match pattern 2" in out

    def test_match_stream_equals_whole(self, files, capsys):
        pat, inp = files
        out = _both(["match", "-P", pat, "-I", inp, "--platform", "cpu",
                     "--stream", "--stream-chunk", "4"], capsys)
        assert "num_matched = 5" in out

    def test_match_space_driven(self, files, capsys):
        pat, inp = files
        out = _both(["match", "-P", pat, "-I", inp, "--platform", "cpu", "-S"],
                    capsys)
        assert "num_matched = 5" in out


@pytest.mark.parametrize("platform", ["device", "cpu_parallel"])
def test_match_on_torch_cpu_equals_reference(files, capsys, platform):
    pat, inp = files
    argv = ["match", "-P", pat, "-I", inp, "--platform", platform,
            "--head", "3"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert ref_cli.main(argv) == 0
    assert out == capsys.readouterr().out
    assert "... (2 more; --all to print)" in out


def test_sharded_is_refused(files, capsys):
    """The name stays; the refusal went with distribution's port:
    ``--sharded`` on one and on four CPU shards prints what the reference
    CLI's ``--sharded`` prints (its 8-device CPU mesh)."""
    pat, inp = files
    argv = ["match", "-P", pat, "-I", inp, "--sharded"]
    assert ref_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert "num_matched = 5" in want
    for shards in (1, 4):
        assert cli.main(argv + ["--device", "cpu", "--shards",
                                str(shards)]) == 0
        captured = capsys.readouterr()
        assert "not ported" not in captured.err
        assert captured.out == want


def test_profile_on_cpu(files, capsys, tmp_path):
    pat, inp = files
    trace = tmp_path / "trace"
    assert cli.main(["profile", "-P", pat, "-I", inp, "--device", "cpu",
                     "--iters", "2", "--histogram", "--trace",
                     str(trace)]) == 0
    out = capsys.readouterr().out
    report = json.loads(out[:out.index("}") + 1])
    assert report["input_bytes"] == 10 and report["num_matched"] == 5
    assert report["device"] == "cpu" and report["engine"] == "SieveMatcher"
    assert "pattern      4: 2 matches" in out
    assert os.path.getsize(trace / "trace.json") > 0

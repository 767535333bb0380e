"""The port's entry points (``pfac_tpu_torch.tools.bench``, ``bench_matrix``
and ``graft_entry``) on the CPU: the regime corpora against the reference's
own records, the headline line's gates and keys, the matrix's lines, the
walker step of ``entry`` against the reference's ``__graft_entry__.entry``
jitted on JAX's CPU, and the sharded dry run."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pfac_tpu_torch.backends import sieve
from pfac_tpu_torch.backends.sieve_tables import SieveTables
from pfac_tpu_torch.core.automaton import Automaton
from pfac_tpu_torch.tools import bench, bench_matrix, graft_entry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the keys of bench.py's JSON line
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "corpus_mb",
              "num_patterns", "num_states", "matches", "iters", "time_s",
              "estimates_ms", "spread", "device"}
#: the fields tools_bench_matrix.py writes for every regime
REGIME_KEYS = {"regime", "bytes", "ms", "GBps", "device", "spread"}


def test_corpora_reproduce_the_reference_records():
    # BENCH_REGIMES.json, lines 3-4: 396,847 survivors on the virus-dense
    # corpus (every block below the escape's 16,384), 2,012,634 matches
    # in the reduce's vector
    got = {}
    for reg in bench_matrix.corpora():
        if reg.name in ("virus_dense_worst", "reduce_device_3pct"):
            got[reg.name] = reg
        if reg.name == "reduce_device_3pct":
            break
    virus = got["virus_dense_worst"]
    assert virus.host.shape == (8 << 20,) and virus.host.dtype == np.uint8
    tabs = SieveTables.build(Automaton.from_patterns(virus.patterns))
    d = torch.from_numpy(virus.host)
    _, _, counts = sieve.sieve(d, d.shape[0], d.shape[0],
                               tabs.to_device("cpu"))
    assert int(counts.sum()) == 396_847
    assert int(counts.max()) < (1 << 16) // 4
    vec = got["reduce_device_3pct"].host
    assert vec.shape == (64 << 20,) and vec.dtype == np.int32
    assert int((vec > 0).sum()) == 2_012_634
    assert set(np.unique(vec).tolist()) == {0, 7}


def test_bench_gates_and_line(capsys):
    assert bench.main(["--device", "cpu", "--mb", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert BENCH_KEYS <= set(rec)
    assert rec["metric"] == "dense_match_throughput_1chip"
    assert rec["corpus_mb"] == 1 and rec["num_patterns"] == 2000
    assert rec["device"] == "cpu" and rec["power_limit"] is None
    assert rec["value"] > 0 and 3 <= rec["iters"] <= 8
    assert rec["fingerprint"][2] == rec["matches"] > 0
    assert rec["slice_bytes"] == 1 << 20


def test_fingerprint_equals_the_host_formula():
    rng = np.random.default_rng(3)
    r = np.where(rng.random(70_000) < 0.1,
                 rng.integers(1, 100_000, size=70_000), 0).astype(np.int32)
    t = torch.from_numpy(np.concatenate([r, np.full(500, 9, np.int32)]))
    assert bench.fingerprint(t, r.shape[0]) == bench.fingerprint_host(r)
    # the reference's one-shot uint64 formula
    ew = (np.arange(r.shape[0], dtype=np.uint64) * 2654435761) & 0xFFFFFFFF
    ef = r.astype(np.uint64)
    assert bench.fingerprint_host(r) == [
        int(ef.sum()) & 0xFFFFFFFF,
        int(((ef * ew) & 0xFFFFFFFF).sum()) & 0xFFFFFFFF,
        int((ef > 0).sum())]


def test_bench_matrix_lines(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "lines.jsonl"
    assert bench_matrix.main(["--device", "cpu", "--scale", "256",
                              "--out", str(out)]) == 0
    printed = capsys.readouterr().out.strip().splitlines()
    recs = [json.loads(x) for x in printed]
    assert [r["regime"] for r in recs] == list(bench_matrix.REGIMES)
    assert out.read_text().splitlines() == printed
    assert os.listdir(tmp_path) == ["lines.jsonl"]   # no BENCH_REGIMES.json
    by = {r["regime"]: r for r in recs}
    for r in recs:
        assert REGIME_KEYS <= set(r) and r["scale"] == 256
        assert r["device"] == "cpu" and r["ms"] > 0
        assert not any(k.startswith("reference") for k in r)
        if r["regime"] != "reduce_device_3pct":
            assert {"survivors", "kernel_ms", "walker_ms"} <= set(r)
    assert by["reduce_device_3pct"]["matches"] > 0
    assert {"patterns", "alive_resid_bits", "csr_hbm_mb"} <= set(
        by["big_ruleset_100k_defcon"])
    assert by["benchmark1_no_match"]["survivors"] == 0
    assert by["virus_dense_worst"]["survivors"] > 1000
    assert by["defcon_like_1.5pct"]["slice_matches_per_MB"] > 0


def test_bench_matrix_regimes_keep_the_stream():
    # a regime picked alone is the same corpus as in the full order
    full = {r.name: r.host for r in bench_matrix.corpora(scale=512)}
    runs = bench_matrix.prepare("cpu", ["virus_dense_worst",
                                        "benchmark1_all_match"], scale=512)
    assert [r.name for r in runs] == ["virus_dense_worst",
                                      "benchmark1_all_match"]
    for r in runs:
        assert np.array_equal(r.data.numpy(), full[r.name])
        bench_matrix.check(r)


def test_graft_entry_equals_the_reference():
    import jax

    import __graft_entry__ as ref

    ref_fn, ref_args = ref.entry()
    want = np.asarray(jax.jit(ref_fn)(*ref_args))
    fn, args = graft_entry.entry("cpu")
    for x, y in zip(args, ref_args):
        assert np.array_equal(x.numpy(), np.asarray(y))
    got = fn(*args)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert want.any()
    assert graft_entry.example_automaton().sorted_patterns == \
        ref._example_automaton().sorted_patterns


def test_dryrun_multichip_on_cpu_devices():
    line = graft_entry.dryrun_multichip(8, devices=["cpu"] * 8)
    assert line.startswith("dryrun_multichip(8): OK")


@pytest.mark.parametrize("module", ["bench", "bench_matrix", "graft_entry"])
def test_entry_point_needs_a_gpu(module):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    res = subprocess.run([sys.executable, "-m",
                          f"pfac_tpu_torch.tools.{module}"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 1, res.stderr
    assert "no GPU" in res.stderr and res.stdout == ""

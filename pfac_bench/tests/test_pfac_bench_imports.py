"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: ``pfac_tpu_torch`` begins with ``pfac_tpu``."""
import ast
import os
import subprocess
import sys

import pytest

from pfac_bench.layout import PKG_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "pfac_tpu"}


def _sources(sub: str = "") -> list[str]:
    out = []
    for d, _, files in os.walk(os.path.join(PKG_DIR, sub)):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def imports(path: str) -> set[str]:
    """Top-level names of every module `path` imports (relative imports
    resolved inside the benchmark's package)."""
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("pfac_bench" if node.level else
                      node.module.split(".")[0])
    return names


def test_the_scan_finds_imports():
    assert imports(os.path.join(PKG_DIR, "harness.py")) >= {
        "numpy", "torch", "pfac_bench", "pfac_tpu_torch"}


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(
    p, PKG_DIR))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", _sources("reference"),
                         ids=os.path.basename)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not imports(path) & (FORBIDDEN | {"pfac_tpu_torch"})


def test_modules_loaded_by_a_small_run():
    """In a fresh process: the generators, the reference, the metric
    readers and a whole small run; then the loaded top-level names."""
    code = f"""
import sys, torch
sys.path.insert(0, {ROOT!r})
from pfac_bench import harness, reference
from pfac_bench.layout import Bench
b = Bench.load()
before = {{m.split(".")[0] for m in sys.modules}}
trie = reference.build([b"ab", b"abc"])
reference.match_dense(trie, torch.zeros(16, dtype=torch.uint8))
for x in b.manifest["end_to_end"] + b.manifest["per_layer"]:
    b.module("metrics", x["name"])
run = harness.run_cell(b, "snort2k.text_192MB", 9, 0.1, False,
                       torch.device("cpu"), log=lambda _m: None,
                       overrides={{"traffic": {{"corpus": {{"bytes": 65536}}}}}})
assert run.correct
print("BEFORE", " ".join(sorted(before)))
print("AFTER", " ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = dict(line.split(" ", 1) for line in res.stdout.splitlines()
                 if line.startswith(("BEFORE", "AFTER")))
    before, after = (set(lines[k].split()) for k in ("BEFORE", "AFTER"))
    assert not before & (FORBIDDEN | {"pfac_tpu_torch"})
    assert "pfac_tpu_torch" in after
    assert not after & FORBIDDEN

"""Where the benchmark finds its parts, by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, operation,
generator or metric sits in a file of its own, found by name:

* a configuration: the file that its ``configs`` entry names;
* a traffic mix: ``traffic/<name>.json``;
* a ruleset generator: ``rulesets/<kind>.py`` (``make(params)``);
* a corpus generator: ``corpora/<kind>.py`` (``make(params, patterns, n,
  rng, gen, device)``);
* an operation of the program: ``ops/<op>.py`` (class ``Op``, function
  ``compare``), and the bytes it needs: ``bytecount/<op>.py``;
* a metric: ``metrics/<name>.py`` (``read(run)``).

So a later change adds a cell, a mix, a generator or a metric as a new file
and edits none. A :class:`Bench` searches its directories in order, which
lets a test put throwaway parts in a temporary directory before the
package's own.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from types import ModuleType

from . import manifest as manifest_mod

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)


class Bench:
    """The manifest and the directories its parts are found in."""

    def __init__(self, manifest: dict, root: str = ROOT,
                 search: list[str] | None = None):
        self.manifest = manifest
        self.root = root
        self.search = list(search or []) + [PKG_DIR]
        self._modules: dict[str, ModuleType] = {}

    @classmethod
    def load(cls, root: str = ROOT) -> "Bench":
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            return cls(json.load(f), root)

    def _entry(self, key: str, name: str) -> dict:
        for e in self.manifest[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        entry = self._entry("configs", name)
        with open(os.path.join(self.root, entry["file"])) as f:
            return json.load(f)

    def _find(self, kind: str, name: str, ext: str) -> str:
        if not manifest_mod.NAME.fullmatch(name):
            raise ValueError(f"bad {kind} name {name!r}")
        for d in self.search:
            path = os.path.join(d, kind, name + ext)
            if os.path.exists(path):
                return path
        raise FileNotFoundError(f"no {kind}/{name}{ext} under "
                                f"{', '.join(self.search)}")

    def traffic(self, name: str) -> dict:
        with open(self._find("traffic", name, ".json")) as f:
            return json.load(f)

    def module(self, kind: str, name: str) -> ModuleType:
        """``<kind>/<name>.py``, loaded once by its path."""
        path = self._find(kind, name, ".py")
        mod = self._modules.get(path)
        if mod is None:
            safe = re.sub(r"\W", "_", f"{kind}__{name}")
            spec = importlib.util.spec_from_file_location(
                f"_pfac_bench_found_{safe}", path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[spec.name] = mod
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return mod

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of `cell` reports: the end-to-end ones with
        tracing off, the per-layer ones with it on; each where it lists
        the cell or lists none."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.manifest[key]
                if cell in m.get("workloads", [cell])]

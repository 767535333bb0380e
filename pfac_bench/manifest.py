"""The rules ``BENCHMARK.json`` keeps: names, units, keys, bounds and the
chip time a full check takes. :func:`problems` lists every rule a manifest
breaks; the tests hold the committed manifest to it."""
from __future__ import annotations

import os
import re

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E_SOURCES = {"device_trace", "host_clock"}

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}

CHECK_SECONDS = 43200      # what a full check may take
SPARE_SECONDS = 1200
RUN_SLACK = 60             # a run's allowance past run_seconds
COMPILE_SECONDS = 2 * 90   # a cell's compile allowance
MAX_CELLS = 24


def _line(text, limit: int = 200) -> bool:
    return (isinstance(text, str) and 1 <= len(text) <= limit
            and "\n" not in text and "\t" not in text)


def check_seconds(run_seconds: int, cells: int = MAX_CELLS) -> int:
    """Seconds a full check of `cells` cells takes at the allowances."""
    runs = 2 + 14 * cells
    return runs * (run_seconds + RUN_SLACK) + cells * COMPILE_SECONDS \
        + SPARE_SECONDS


def problems(m: dict, root: str | None = None) -> list[str]:
    """Every rule of the benchmark's contract that `m` breaks (files are
    looked for under `root` where it is given)."""
    out: list[str] = []
    if set(m) != TOP_KEYS:
        out.append(f"top-level keys {sorted(m)}")
        return out
    cmd, paths = m["command"], m["paths"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32
            and all(_line(w) for w in cmd)):
        out.append("command")
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16
            and all(isinstance(p, str) and PATH.fullmatch(p)
                    and not p.startswith("/") and ".." not in p.split("/")
                    for p in paths)):
        out.append("paths")
    for w in cmd:
        if w.startswith("/") or ".." in w.split("/"):
            out.append(f"command word {w!r} leaves the checkout")
    rs = m["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        out.append("run_seconds")
    elif check_seconds(rs) > CHECK_SECONDS:
        out.append(f"run_seconds {rs} does not fit {MAX_CELLS} cells")

    names: set[str] = set()

    def name_ok(e: dict, what: str) -> None:
        n = e.get("name")
        if not (isinstance(n, str) and NAME.fullmatch(n)):
            out.append(f"{what} name {n!r}")
        elif n in names:
            out.append(f"{what} name {n!r} used twice")
        names.add(n)

    configs = {}
    if not 1 <= len(m["configs"]) <= 24:
        out.append("configs: 1 to 24")
    files = set()
    for c in m["configs"]:
        if set(c) != CONFIG_KEYS:
            out.append(f"config keys {sorted(c)}")
            continue
        name_ok(c, "config")
        configs[c["name"]] = c
        if not (_line(c["source"]) and _line(c["why"])):
            out.append(f"config {c['name']}: source or why")
        if not (isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
                and all(isinstance(k, str) and NAME.fullmatch(k)
                        for k in c["reduced"])):
            out.append(f"config {c['name']}: reduced")
        f = c["file"]
        if f in files or not any(f.startswith(p.rstrip("/") + "/")
                                 for p in paths):
            out.append(f"config {c['name']}: file {f!r}")
        files.add(f)
        if root is not None and not os.path.exists(os.path.join(root, f)):
            out.append(f"config {c['name']}: {f} missing")

    cells = m["workloads"]
    if not 1 <= len(cells) <= 24:
        out.append("workloads: 1 to 24")
    pairs = set()
    for w in cells:
        if set(w) != CELL_KEYS:
            out.append(f"workload keys {sorted(w)}")
            continue
        name_ok(w, "workload")
        if w["config"] not in configs:
            out.append(f"workload {w['name']}: config {w['config']!r}")
        if not (isinstance(w["traffic"], str)
                and NAME.fullmatch(w["traffic"])):
            out.append(f"workload {w['name']}: traffic")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"workload {w['name']}: pair used twice")
        pairs.add((w["config"], w["traffic"]))
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']}: chips")
        if not _line(w["why"]):
            out.append(f"workload {w['name']}: why")
    four = sum(w.get("chips") == 4 for w in cells)
    if four > max(1, len(cells) // 4):
        out.append(f"{four} cells on 4 chips")
    used = {w.get("config") for w in cells}
    for c in configs:
        if c not in used:
            out.append(f"config {c} used by no cell")
    cell_names = {w.get("name") for w in cells}

    def metric_ok(x: dict, keys: set[str], sources: set[str]) -> None:
        if set(x) - {"workloads"} != keys:
            out.append(f"metric keys {sorted(x)}")
            return
        name_ok(x, "metric")
        if not UNIT.fullmatch(str(x["unit"])):
            out.append(f"metric {x['name']}: unit {x['unit']!r}")
        if x["better"] not in ("lower", "higher"):
            out.append(f"metric {x['name']}: better")
        if x["source"] not in sources:
            out.append(f"metric {x['name']}: source {x['source']!r}")
        for c in x.get("workloads", []):
            if c not in cell_names:
                out.append(f"metric {x['name']}: workload {c!r}")

    e2e = m["end_to_end"]
    if not 1 <= len(e2e) <= 16:
        out.append("end_to_end: 1 to 16")
    for x in e2e:
        metric_ok(x, E2E_KEYS, E2E_SOURCES)
        b = x.get("bound")
        if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
            out.append(f"metric {x.get('name')}: bound {b!r}")
    if "setup_s" not in {x.get("name") for x in e2e}:
        out.append("no setup_s")
    e2e_names = {x.get("name") for x in e2e}
    layer = m["per_layer"]
    if not 1 <= len(layer) <= 128:
        out.append("per_layer: 1 to 128")
    for x in layer:
        metric_ok(x, LAYER_KEYS, SOURCES)
        if x.get("moves") not in e2e_names:
            out.append(f"metric {x.get('name')}: moves {x.get('moves')!r}")
        if not _line(x.get("layer")):
            out.append(f"metric {x.get('name')}: layer")
    for w in cells:
        n = w.get("name")
        got_e2e = [x["name"] for x in e2e if n in x.get("workloads", [n])]
        got_layer = [x for x in layer if n in x.get("workloads", [n])]
        if "setup_s" not in got_e2e or len(got_e2e) < 2 or not got_layer:
            out.append(f"workload {n}: metrics it reports")
        for x in got_layer:
            if x.get("moves") not in got_e2e:
                out.append(f"workload {n}: {x['name']} moves a metric it "
                           "does not report")
    return out

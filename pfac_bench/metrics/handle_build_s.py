"""The program's own seconds of building its handle, in s: the sum of its
``build.*_s`` counters (the automaton, the engine's host tables and their
copy to the card, the kernels' library built or loaded, the programs'
geometry and graphs). Set-up builds every program the window uses, so this
is set-up's building unless a request had to build. The inside twin of
``engine_build_s``. Left out where the run built no program (no card: the
CPU path builds no handle for one)."""
from pfac_bench import counters


def value(c: dict | None) -> float | None:
    if c is None or not c.get("build.programs"):
        return None
    parts = [v for k, v in c.items()
             if k.startswith("build.") and k.endswith("_s")]
    return float(sum(parts)) if parts else None


def read(run) -> float | None:
    return value(counters.read())

"""The mean host time of a request's outermost span in the program
(``pfac.match_device`` or ``pfac.match_reduce_device``, the handle's call),
in microseconds: the program's own span, timed by the program while the
profiler recorded (the traced run's warm-up and window). The inside twin of
``host_call_us``, with the profiler's cost on every traced op in it. Left
out where the run built no program (no card: the CPU path has spans but
runs none of the card's layers they time)."""
from pfac_bench import counters

OUTER = ("pfac.match_device", "pfac.match_reduce_device")


def value(c: dict | None) -> float | None:
    if c is None or not c.get("build.programs"):
        return None
    calls = sum(c.get(f"span.{n}.calls", 0) for n in OUTER)
    secs = sum(c.get(f"span.{n}.s", 0.0) for n in OUTER)
    return secs / calls * 1e6 if calls else None


def read(run) -> float | None:
    return value(counters.read())

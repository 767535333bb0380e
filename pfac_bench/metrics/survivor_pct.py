"""K1's survivors over the positions the programs scanned, in %: the
positions the sieve let through to the survivor walk (the card's counter
that ``compact_scan_kernel`` adds to, dense blocks left out) over every
program call's padded positions, across the run (set-up, window and traced
window: the same batches in turn). It tells a change of the sieve from a
change of the traffic."""
from pfac_bench import counters


def value(c: dict | None) -> float | None:
    if c is None or not c.get("positions") or "survivors" not in c:
        return None
    return 100.0 * c["survivors"] / c["positions"]


def read(run) -> float | None:
    return value(counters.read())

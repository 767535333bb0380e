"""K3's exact-table probes a position it walked, in probes:
``block_walk_probes`` (the probes K3 issued, a dead position's in a batch
included: the work its batching spends) over ``block_walk_positions``,
the card's counters over the run's whole. It moves with the ruleset's
depth and K3's dealing, not with its speed. Left out where the run has no
such counters (a port that predates them, the control) or K3 walked
nothing."""
from pfac_bench import counters


def value(c: dict | None) -> float | None:
    if c is None or not c.get("block_walk_positions") \
            or "block_walk_probes" not in c:
        return None
    return c["block_walk_probes"] / c["block_walk_positions"]


def read(run) -> float | None:
    return value(counters.read())

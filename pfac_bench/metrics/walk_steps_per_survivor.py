"""K2's loop iterations a survivor, in steps: ``walk_steps`` (the card's
counter K2 adds to: the iterations in which a lane had a walk, the entry
probe one) over ``survivors`` (the positions the compaction handed K2),
the run's whole. It moves with the traffic's depth and not with the
walker's speed, so it tells deeper traffic from a slower walker. Left out
where the run has no such counters (a port that predates them, the
control) or K2 walked nothing (no card: the CPU path builds no program)."""
from pfac_bench import counters


def value(c: dict | None) -> float | None:
    if c is None or not c.get("survivors") or not c.get("walk_steps"):
        return None
    return c["walk_steps"] / c["survivors"]


def read(run) -> float | None:
    return value(counters.read())

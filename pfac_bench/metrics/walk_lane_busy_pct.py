"""The share of K2's lane slots that walked, in %: ``walk_steps`` (the
iterations in which a lane had a walk) over ``walk_slots`` (each warp's
iterations times 32: a warp steps as long as its busiest lane), the card's
counters over the run's whole. It shows how well the persistent grid's
refilling lanes keep the warps busy. Left out where the run has no such
counters (a port that predates them, the control) or K2 walked nothing
(no card)."""
from pfac_bench import counters


def value(c: dict | None) -> float | None:
    if c is None or not c.get("walk_slots") or "walk_steps" not in c:
        return None
    return 100.0 * c["walk_steps"] / c["walk_slots"]


def read(run) -> float | None:
    return value(counters.read())

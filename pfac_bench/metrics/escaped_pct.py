"""The positions K3 walked over the positions the programs scanned, in %:
``block_walk_positions`` (the card's counter K3 adds to: the positions
below n of the dense blocks' tiles it walked) over every program call's
padded positions, the run's whole. It tells a change of the dense-block
escape from a change of the traffic, as ``survivor_pct`` does for K1, and
cross-checks ``blocks_escaped``. Left out where the run has no such
counters (a port that predates them, the control) or built no program
(no card)."""
from pfac_bench import counters


def value(c: dict | None) -> float | None:
    if c is None or not c.get("positions") \
            or "block_walk_positions" not in c:
        return None
    return 100.0 * c["block_walk_positions"] / c["positions"]


def read(run) -> float | None:
    return value(counters.read())

"""K3's least time over its own time in the traced window, in %: the
bytes K3 needs for the positions it walked in the window's requests
(:func:`least_bytes`) over the card's peak bandwidth (``peaks.json``),
against the device seconds of the ops named ``block_walk_kernel...``
(``torch.profiler``). The positions a request are the run's
``block_walk_positions`` over its program calls (every request is one
call on a batch of one size). Left out where the run has no such counters
(a port that predates them, the control), no trace, or K3 walked
nothing."""
from pfac_bench import counters

KERNEL = "block_walk_kernel"


def least_bytes(positions: int) -> int:
    """K3 reads a position's byte once and writes its 4-byte ID once."""
    return 5 * positions


def value(c: dict | None, requests: int, kernel_s: float,
          peak_bytes_per_s: float | None) -> float | None:
    if c is None or not c.get("block_walk_positions") \
            or not c.get("launch.program") or requests <= 0 \
            or kernel_s <= 0 or not peak_bytes_per_s:
        return None
    per_call = c["block_walk_positions"] / c["launch.program"]
    return 100.0 * least_bytes(per_call * requests) / peak_bytes_per_s \
        / kernel_s


def read(run) -> float | None:
    t, w = run.trace, run.traced
    if t is None or w is None:
        return None
    kernel_s = sum(s for name, s in t.device_ops if name.startswith(KERNEL))
    return value(counters.read(), w.completed, kernel_s,
                 run.peak_bytes_per_s)

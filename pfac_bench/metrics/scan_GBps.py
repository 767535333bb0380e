"""Bytes of every request completed in the window over the window's
seconds (first call to last completion), in GB/s (10^9 B); host clock."""


def read(run) -> float | None:
    w = run.window
    if not w.completed or w.seconds <= 0:
        return None
    return sum(w.nbytes) / w.seconds / 1e9

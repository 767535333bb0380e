"""The least time of the traced window's requests over the card's busy
time in it, in %: the bytes each operation needs (``bytecount/``) over the
card's peak bandwidth (``peaks.json``), against the union of the device's
activity in the profiled window (``torch.profiler``). It reads the same
work whatever kernels implement the operation."""


def read(run) -> float | None:
    t, w = run.trace, run.traced
    if t is None or w is None or not w.completed or t.busy_s <= 0 \
            or run.peak_bytes_per_s is None:
        return None
    return 100.0 * sum(w.least_bytes) / run.peak_bytes_per_s / t.busy_s

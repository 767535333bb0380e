"""The share of the profiled window in which nothing ran on the card, in
% (``torch.profiler``'s CUDA timeline: kernels, copies, memsets)."""


def read(run) -> float | None:
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

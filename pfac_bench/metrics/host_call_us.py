"""The mean over the window's requests of the host's time inside the call
(from the call to its return, which does not wait for the card), in
microseconds; the benchmark's host clock around the call."""


def read(run) -> float | None:
    c = run.window.call_s
    return sum(c) / len(c) * 1e6 if c else None

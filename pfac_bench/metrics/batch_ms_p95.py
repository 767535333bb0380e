"""The 95th percentile of every window request's latency, in ms: the host
clock from just before the call to the host knowing the result is complete
(the wait on the event recorded after the call and its read-back
returned)."""
import numpy as np


def read(run) -> float | None:
    lat = run.window.latency_ms
    return float(np.percentile(lat, 95)) if lat else None

"""The program's own counters, where the run loaded them: the registry of
``pfac_tpu_torch.trace`` (each kernel's launches, the positions the
programs scanned, the seconds the handle's parts took to build, the spans'
totals while the profiler recorded, and the card's counters of K1's
survivors and of the blocks K3 walked whole).

The registry is the process's and lives as long as it, so a reader finds
it after the run has freed the handle. It is looked up in ``sys.modules``
and never imported: where the run loaded no such registry (a port that
predates it, the control) :func:`read` returns None and the metrics that
read it are left out. The counters cover the whole run: set-up, the
window and the traced window."""
from __future__ import annotations

import sys

REGISTRY = "pfac_tpu_torch.trace"


def read() -> dict | None:
    """Every counter of the registry, the device's included (read now),
    or None where the run loaded no registry."""
    mod = sys.modules.get(REGISTRY)
    if mod is None or not hasattr(mod, "counters"):
        return None
    out = dict(mod.counters())
    device = getattr(mod, "device_counters", None)
    if device is not None:
        out.update(device())
    return out

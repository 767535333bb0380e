"""Backend selection: counterpart of ``pfac_tpu.backends.pallas.try_build``.

``try_build`` returns the sieve engine (``SieveMatcher``: the sieve kernel
K1, then the walk-table tier, K3 + K2, or the CSR tier) or ``None`` where
the reference returns ``None``, and the runtime then builds the lockstep
walker (``xla.XlaMatcher``):

* ``PlacementMode.HBM`` (``PFAC_TEXTURE_OFF``: tables read from device
  memory) always takes the walker;
* a host-table build that raises (sieve tables past the 8 MB budget, or a
  CHD displacement search that fails to converge) takes the walker unless
  the sieve engine is required (``Backend.PALLAS`` or
  ``PlacementMode.VMEM``), where the error goes to the caller.

Only the host tables are built inside the ``try``, before anything touches
a device, so a CUDA build, load or launch error is never caught.

The port's own rule for ``Backend.AUTO`` on the CPU: the sieve engine,
with its kernels' plain versions. The reference takes its ``XlaMatcher``
off a TPU; both give equal results, and the CPU tests hold the sieve
engine's plain versions against the reference that way.
"""
from __future__ import annotations

from ..runtime.handle import PlacementMode
from .sieve_matcher import SieveMatcher, build_host_tables


def try_build(automaton, mode, *, placement, tile, device, required: bool):
    del mode  # the sieve kernel subsumes dense/hash: same semantics
    if placement == PlacementMode.HBM:
        return None
    required = required or placement == PlacementMode.VMEM
    try:
        host = build_host_tables(automaton)
    except Exception:
        if required:
            raise
        return None
    kw = {}
    if tile:
        kw["tile_rows"] = max(64, (tile // 128) // 64 * 64)
    return SieveMatcher(automaton, device=device, host=host, **kw)

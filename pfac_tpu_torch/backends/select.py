"""Backend selection: counterpart of ``pfac_tpu.backends.pallas.try_build``.

The port's device engine is ``SieveMatcher``: the sieve kernel K1, then the
walk-table tier (K3 + K2) or, for big or wide rulesets, the CSR tier. Where
the reference would take the XLA lockstep walker (oversized sieve tables,
HBM placement), which the port does not have yet, it raises
``PfacError(INVALID_PARAMETER)`` naming it (here or in ``SieveMatcher``); it
never silently picks another engine.
"""
from __future__ import annotations

from ..runtime.handle import PlacementMode
from ..status import PfacError, PfacStatus
from .sieve_matcher import SieveMatcher


def try_build(automaton, *, placement, tile, device) -> SieveMatcher:
    if placement == PlacementMode.HBM:
        raise PfacError(PfacStatus.INVALID_PARAMETER,
                        "HBM placement needs the XLA lockstep walker, which "
                        "is not ported yet")
    kw = {}
    if tile:
        kw["tile_rows"] = max(64, (tile // 128) // 64 * 64)
    return SieveMatcher(automaton, device=device, **kw)

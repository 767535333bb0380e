"""Matcher: the runtime handle of the port.

Same constructor, setters and match methods as
``pfac_tpu.runtime.handle.Matcher`` (it subclasses it: configuration, the
CPU golden platform, chunking past ``_CHUNK_LIMIT`` and ``stream()`` are
host code shared with the reference), plus an explicit torch ``device``.
Only engine selection differs:

* ``Platform.DEVICE`` with ``Backend.AUTO``/``PALLAS``: the sieve engine
  (``backends.select.try_build``; walk-table or CSR tier) on ``device``;
  ``device="cuda"`` runs the CUDA kernels, ``device="cpu"`` their plain
  torch versions;
* ``Platform.CPU`` and ``Backend.GOLDEN``: the serial numpy golden model;
* ``Backend.XLA`` and ``Platform.CPU_PARALLEL`` raise ``PfacError`` until the
  lockstep walker is ported.
"""
from __future__ import annotations

import torch
from pfac_tpu.runtime import handle as _ref
from pfac_tpu.runtime.handle import Backend, PerfMode, PlacementMode, Platform

from ..status import PfacError, PfacStatus

__all__ = ["Backend", "Matcher", "PerfMode", "PlacementMode", "Platform"]


class Matcher(_ref.Matcher):
    """Compile patterns once, match many inputs on a torch device.

    >>> m = Matcher([b"AB", b"ABG", b"BEDE", b"ED"], device="cpu")
    >>> m.match(b"ABEDEDABG").tolist()
    [1, 3, 4, 0, 4, 0, 2, 0, 0]
    """

    def __init__(self, patterns=None, *, device="cuda", **kw):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise PfacError(PfacStatus.INVALID_PARAMETER,
                            "CUDA device requested but no GPU is available")
        if device.type not in ("cuda", "cpu"):
            raise PfacError(PfacStatus.INVALID_PARAMETER,
                            f"unsupported device {device}")
        super().__init__(patterns, device=device, **kw)

    def _build_engine(self):
        if self.platform == Platform.CPU_PARALLEL or self.backend == Backend.XLA:
            raise PfacError(
                PfacStatus.INVALID_PARAMETER,
                "the XLA lockstep walker (Backend.XLA, Platform.CPU_PARALLEL) "
                "is not ported yet",
            )
        if self.backend == Backend.GOLDEN:
            return super()._build_engine()
        from ..backends.select import try_build
        return try_build(self.automaton, placement=self.placement,
                         tile=self.tile, device=self.device)

"""Device matcher: the walk-table tier and the CSR tier.

Counterpart of ``pfac_tpu.backends.pallas_sieve.SieveMatcher``, with the
same methods and output contract: ``match_device`` returns int32 padded to
``npad_for(n)`` (64K-position buckets) with the tail zeroed, ``match``
slices it to n, and result[i] is the ID of the longest pattern starting at
byte i, else 0.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import Automaton
from ..status import PfacError, PfacStatus
from . import pipeline
from .csr_tables import CsrTables, build_csr_tables
from .golden import _as_u8, reduce_result
from .reduce import reduce_from_dense
from .sieve_tables import _VMEM_TABLE_BUDGET, LANES, SieveTables
from .walk_tables import WalkTables, build_walk_tables_gated

TILE_ROWS = 512              # positions per bucket = TILE_ROWS * LANES
_POS_LIMIT = (1 << 31) - (1 << 22)   # int32 positions, as the reference


def npad_for(n: int, tile_rows: int = TILE_ROWS) -> int:
    """Positions padded up to the bucket granularity."""
    block = tile_rows * LANES
    return max(1, -(-n // block)) * block


def build_host_tables(automaton: Automaton) -> tuple[
        SieveTables, WalkTables | None, CsrTables | None]:
    """The engine's host tables (numpy; nothing touches a device): the sieve
    tables, then the walk tables within their 6 MB budget, else the CSR
    tables. Raises PfacError where the sieve tables pass the reference's
    8 MB budget; ``select.try_build`` falls back to the lockstep walker on
    that, or on any other error raised here, as the reference does."""
    tables = SieveTables.build(automaton)
    if tables.vmem_bytes > _VMEM_TABLE_BUDGET:
        raise PfacError(
            PfacStatus.INVALID_PARAMETER,
            f"sieve tables of {tables.vmem_bytes} bytes exceed the sieve "
            f"engine's budget of {_VMEM_TABLE_BUDGET} bytes",
        )
    walk_tables = build_walk_tables_gated(automaton, tables)
    csr_tables = None
    if walk_tables is None and tables.alive is not None:
        csr_tables = build_csr_tables(automaton)
    return tables, walk_tables, csr_tables


class SieveMatcher:
    """Sieve kernel + deep tier on one torch device.

    The deep tier is the walk-table tier (dense-block escape K3, survivor
    walk K2) when the walk tables can be built within their 6 MB budget,
    else the CSR tier (CSR walk) for rulesets with patterns of >= 4 bytes.
    `host` takes the tables of :func:`build_host_tables` built beforehand
    (``select.try_build`` builds them apart, so that nothing it catches
    comes from a device)."""

    def __init__(self, automaton: Automaton, *, device, tile_rows=TILE_ROWS,
                 host=None):
        self.automaton = automaton
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.tile_rows = tile_rows
        if host is None:
            host = build_host_tables(automaton)
        self.tables, self.walk_tables, self.csr_tables = host
        self._sieve = self.tables.to_device(self.device)
        self._walk = (None if self.walk_tables is None
                      else self.walk_tables.to_device(self.device))
        self._csr = (None if self.csr_tables is None
                     else self.csr_tables.to_device(self.device))

    def _run(self, data: torch.Tensor, n: int,
             npad: int | None = None) -> torch.Tensor:
        """-> int32[npad] (default ``npad_for(n)``), 0 at and past n."""
        if n > _POS_LIMIT:
            raise PfacError(
                PfacStatus.INVALID_PARAMETER,
                "input exceeds the int32 position range; feed < 2 GiB chunks",
            )
        if npad is None:
            npad = npad_for(n, self.tile_rows)
        return pipeline.run(data, n, npad,
                            self._sieve, self._walk, self._csr,
                            block=self.tile_rows * LANES)

    def match_device(self, data_u8: torch.Tensor) -> torch.Tensor:
        """uint8[N] on this device -> int32[npad_for(N)] (tail zeroed)."""
        if data_u8.device != self.device:
            raise PfacError(PfacStatus.INVALID_PARAMETER,
                            f"data is on {data_u8.device}, matcher on "
                            f"{self.device}")
        return self._run(data_u8, int(data_u8.shape[0]))

    def flush_checks(self) -> None:
        """Nothing is deferred: neither deep tier has a stage capacity."""

    def match(self, data) -> np.ndarray:
        arr = _as_u8(data)
        n = arr.shape[0]
        if n == 0:
            return np.zeros(0, dtype=np.int32)
        dev = torch.from_numpy(arr.copy()).to(self.device)
        return self._run(dev, n)[:n].cpu().numpy()

    def match_reduce_device(self, data_u8: torch.Tensor):
        """-> (ids, positions, count) on the device: npad-long int32 arrays,
        positions ascending, zeros past count; count a 0-d int32 tensor
        (``reduce.py``; on the card it never waits for the device)."""
        return reduce_from_dense(self.match_device(data_u8))

    def match_reduce(self, data):
        return reduce_result(self.match(data))

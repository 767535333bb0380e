"""Matcher: the runtime handle of the port.

The same constructor, setters and match methods as
``pfac_tpu.runtime.handle.Matcher``, plus an explicit torch ``device``. The
host logic is the reference's (configuration, the CPU golden platform,
chunking past ``_CHUNK_LIMIT``, ``stream()``), and so is engine selection
(``_build_engine``):

* ``Backend.GOLDEN``, and ``match`` / ``match_reduce`` on ``Platform.CPU``:
  the serial numpy golden model;
* ``Platform.DEVICE`` with ``Backend.AUTO`` / ``PALLAS``: the sieve engine
  (``backends.select.try_build``; walk-table or CSR tier) on ``device``;
  ``device="cuda"`` runs the CUDA kernels, ``device="cpu"`` their plain
  torch versions;
* everything else, and where ``try_build`` returns ``None``
  (``PlacementMode.HBM``, or sieve tables that cannot be built unless the
  sieve engine is required): the lockstep walker ``backends.xla.XlaMatcher``
  in ``perf_mode``, on ``device`` for ``Platform.DEVICE`` and on
  ``torch.device("cpu")`` for ``Platform.CPU`` and ``CPU_PARALLEL``.

Only ``Platform.DEVICE`` needs the device: ``Matcher(..., platform="cpu")``
runs on a host with no GPU whatever ``device`` says.

``match_device`` and ``match_reduce_device`` are the request's outermost
spans (``pfac.match_device``, ``pfac.match_reduce_device``) while
``torch.profiler`` records; :meth:`Matcher.counters` reads the port's
counters (``trace``).

Mode mapping from the CUDA PFAC library: ``PFAC_setPlatform(GPU/CPU/
CPU_OMP)`` -> ``Platform``; ``PFAC_setPerfMode(TIME/SPACE_DRIVEN)`` ->
``PerfMode.DENSE/HASH``; ``PFAC_setTextureMode(AUTO/ON/OFF)`` ->
``PlacementMode.AUTO/VMEM/HBM`` (VMEM: tables kept on chip; HBM: tables
read from device memory).
"""
from __future__ import annotations

import enum
from collections import Counter
from typing import Sequence

import numpy as np
import torch

from .. import trace
from ..core.automaton import Automaton
from ..status import PfacError, PfacStatus

__all__ = ["Backend", "Matcher", "PerfMode", "PlacementMode", "Platform"]


class Platform(enum.IntEnum):
    DEVICE = 0        # PFAC_PLATFORM_GPU (default)
    CPU = 1           # PFAC_PLATFORM_CPU (serial golden model)
    CPU_PARALLEL = 2  # PFAC_PLATFORM_CPU_OMP


class PerfMode(enum.IntEnum):
    DENSE = 0  # PFAC_TIME_DRIVEN (default)
    HASH = 1   # PFAC_SPACE_DRIVEN


class PlacementMode(enum.IntEnum):
    AUTO = 0  # PFAC_AUTOMATIC (default)
    VMEM = 1  # PFAC_TEXTURE_ON
    HBM = 2   # PFAC_TEXTURE_OFF


class Backend(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    PALLAS = "pallas"
    GOLDEN = "golden"


class _GoldenEngine:
    """The serial numpy golden model behind the engine interface."""

    def __init__(self, automaton: Automaton, mode: str):
        self.automaton, self.mode = automaton, mode

    def match(self, data):
        from ..backends import golden
        return golden.match(self.automaton, data, self.mode)

    def match_reduce(self, data):
        from ..backends import golden
        return golden.reduce_result(self.match(data))

    def match_device(self, data_u8):
        raise PfacError(PfacStatus.INVALID_PARAMETER,
                        "golden backend has no device path")

    match_reduce_device = match_device


class Matcher:
    """Compile patterns once, match many inputs on a torch device.

    >>> m = Matcher([b"AB", b"ABG", b"BEDE", b"ED"], device="cpu")
    >>> m.match(b"ABEDEDABG").tolist()
    [1, 3, 4, 0, 4, 0, 2, 0, 0]
    """

    #: device engines address positions as int32; larger inputs stream
    #: (SieveMatcher refuses more than this many positions)
    _CHUNK_LIMIT = (1 << 31) - (1 << 22)
    _chunk_step = 1 << 30     # feed size for the auto-chunked path

    def __init__(
        self,
        patterns: Sequence[bytes] | None = None,
        *,
        pattern_file: str | None = None,
        automaton: Automaton | None = None,
        perf_mode: PerfMode | str = PerfMode.DENSE,
        platform: Platform | str = Platform.DEVICE,
        placement: PlacementMode | str = PlacementMode.AUTO,
        backend: Backend | str = Backend.AUTO,
        tile: int | None = None,
        device="cuda",
    ):
        device = torch.device(device)
        if device.type not in ("cuda", "cpu"):
            raise PfacError(PfacStatus.INVALID_PARAMETER,
                            f"unsupported device {device}")
        nsrc = sum(x is not None for x in (patterns, pattern_file, automaton))
        if nsrc != 1:
            raise PfacError(
                PfacStatus.INVALID_PARAMETER,
                "exactly one of patterns / pattern_file / automaton required",
            )
        if automaton is not None:
            self.automaton = automaton
        else:
            with trace.timed("build.automaton_s"):
                self.automaton = (
                    Automaton.from_pattern_file(pattern_file)
                    if pattern_file is not None
                    else Automaton.from_patterns(patterns))
        self.perf_mode = _coerce(PerfMode, perf_mode)
        self.platform = _coerce(Platform, platform)
        self.placement = _coerce(PlacementMode, placement)
        self.backend = Backend(backend)
        self.tile = tile
        self.device = device
        self._engines: dict = {}
        if self.platform == Platform.DEVICE:
            self._check_device()

    def _check_device(self) -> None:
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise PfacError(PfacStatus.INVALID_PARAMETER,
                            "CUDA device requested but no GPU is available")

    # ------------------------------------------------------------- config
    def set_perf_mode(self, perf_mode: PerfMode | str) -> None:
        """Tables are built lazily per mode and cached: switching is free."""
        self.perf_mode = _coerce(PerfMode, perf_mode)

    def set_platform(self, platform: Platform | str) -> None:
        self.platform = _coerce(Platform, platform)

    def set_placement(self, placement: PlacementMode | str) -> None:
        self.placement = _coerce(PlacementMode, placement)

    # -------------------------------------------------------------- match
    def _mode(self) -> str:
        return "dense" if self.perf_mode == PerfMode.DENSE else "hash"

    def match(self, data) -> np.ndarray:
        """`PFAC_matchFromHost` analog: bytes in, int32[N] of pattern IDs out
        (result[i] = longest pattern starting at byte i, 0 if none). Inputs
        past the int32 position range stream through StreamMatcher."""
        n = _len_of(data)
        if n == 0:
            return np.zeros(0, dtype=np.int32)
        if self.platform == Platform.CPU:
            from ..backends import golden
            return golden.match(self.automaton, data, self._mode())
        if n > self._CHUNK_LIMIT:
            return self._match_chunked(data, n)
        return self._engine().match(data)

    def _match_chunked(self, data, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.int32)
        step = self._chunk_step
        sm = self.stream(min_batch=min(1 << 20, step))
        for off in range(0, n, step):
            start, ids = sm.feed(data[off: off + step])
            out[start: start + ids.shape[0]] = ids
        start, ids = sm.finish()
        out[start: start + ids.shape[0]] = ids
        return out

    @trace.spanned("pfac.match_device")
    def match_device(self, data_u8):
        """`PFAC_matchFromDevice` analog: uint8 tensor on the device in,
        int32 tensor out, padded with zeros: to the 64K-position bucket on
        the sieve engine, to whole tiles on the lockstep walker."""
        return self._engine().match_device(data_u8)

    def match_reduce(self, data) -> tuple[np.ndarray, np.ndarray, int]:
        """`PFAC_matchFromHostReduce` analog: (ids, positions, count)."""
        if _len_of(data) == 0:
            z = np.zeros(0, dtype=np.int32)
            return z, z, 0
        if self.platform == Platform.CPU:
            from ..backends import golden
            return golden.reduce_result(
                golden.match(self.automaton, data, self._mode()))
        return self._engine().match_reduce(data)

    @trace.spanned("pfac.match_reduce_device")
    def match_reduce_device(self, data_u8):
        return self._engine().match_reduce_device(data_u8)

    def flush_checks(self) -> None:
        """Validate deferred device-path error flags; the port's engines
        defer none, so this only calls their no-op."""
        for eng in self._engines.values():
            flush = getattr(eng, "flush_checks", None)
            if flush is not None:
                flush()

    def stream(self, *, min_batch: int = 1 << 20):
        """A StreamMatcher over this handle: exact chunked matching with
        carry-over across chunk boundaries (see runtime/stream.py)."""
        from .stream import StreamMatcher
        return StreamMatcher(self, min_batch=min_batch)

    # --------------------------------------------------------- introspect
    def counters(self) -> Counter:
        """The port's counters (``trace.counters``: launches, positions
        scanned, K2's whole and split calls, programs built, set-up
        seconds, span totals while profiled)
        and the device counters (``trace.DEVICE_KEYS``: ``survivors``,
        ``blocks_escaped``, ``short_probes``, ``walk_steps``,
        ``walk_slots``, ``block_walk_probes``, ``block_walk_positions``,
        ``compact_wordwise_chunks``),
        read now. They are the process's: every handle adds to them. A key
        never counted reads 0. This read, and no call, waits for the
        card."""
        out = trace.counters()
        out.update(trace.device_counters())
        return out

    def dump_transition_table(self, fp=None) -> str:
        return self.automaton.dump_transition_table(fp)

    def memory_usage(self) -> str:
        return self.automaton.memory_usage(self._mode())

    # ------------------------------------------------------------ engines
    def _engine(self):
        key = (self.platform, self.perf_mode, self.backend, self.placement)
        eng = self._engines.get(key)
        if eng is None:
            eng = self._build_engine()
            self._engines[key] = eng
        return eng

    def _build_engine(self):
        mode = self._mode()
        device = self.device
        if self.platform == Platform.DEVICE:
            self._check_device()
        else:
            device = torch.device("cpu")
        if self.backend == Backend.GOLDEN:
            return _GoldenEngine(self.automaton, mode)
        if (self.backend in (Backend.AUTO, Backend.PALLAS)
                and self.platform == Platform.DEVICE):
            from ..backends.select import try_build
            eng = try_build(self.automaton, mode, placement=self.placement,
                            tile=self.tile, device=device,
                            required=self.backend == Backend.PALLAS)
            if eng is not None:
                return eng
        from ..backends.xla import DEFAULT_TILE, XlaMatcher
        return XlaMatcher(self.automaton, perf_mode=mode,
                          tile=self.tile or DEFAULT_TILE, device=device)


def _coerce(enum_cls, v):
    if isinstance(v, enum_cls):
        return v
    if isinstance(v, str):
        key = v.upper()
        aliases = {
            "TIME_DRIVEN": "DENSE", "SPACE_DRIVEN": "HASH",
            "GPU": "DEVICE", "TPU": "DEVICE", "CPU_OMP": "CPU_PARALLEL",
            "TEXTURE_ON": "VMEM", "TEXTURE_OFF": "HBM", "AUTOMATIC": "AUTO",
        }
        key = aliases.get(key, key)
        try:
            return enum_cls[key]
        except KeyError:
            pass
    try:
        return enum_cls(v)
    except ValueError:
        raise PfacError(PfacStatus.INVALID_PARAMETER,
                        f"bad {enum_cls.__name__}: {v!r}")


def _len_of(data) -> int:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return len(data)
    return int(np.asarray(data).shape[0])

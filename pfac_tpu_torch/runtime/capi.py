"""C-style API of the port: counterpart of ``pfac_tpu.runtime.capi``.

One-to-one equivalents of the C library's entry points (PFAC.h) with the
same handle/status-code discipline: every function returns a PfacStatus,
never raises, and writes results through caller-provided buffers where the
C API did. Device arguments are torch tensors on the handle's device (a
``device`` given to ``PFAC_create``, ``"cuda"`` by default):

    handle = []                                  # PFAC_handle_t *
    PFAC_create(handle)                          # PFAC_create(&handle)
    PFAC_readPatternFromFile(handle[0], path)
    result = np.zeros(len(data), np.int32)
    PFAC_matchFromHost(handle[0], data, len(data), result)

The port's engines defer no error check, so ``PFAC_synchronize`` and the
per-call flush of ``PFAC_matchFromDevice[Reduce]`` only call the engines'
``flush_checks``; the discipline is the reference's all the same.
"""
from __future__ import annotations

import sys
from typing import MutableSequence

from ..core.automaton import Automaton
from ..status import PfacError, PfacStatus
from .handle import Matcher, PerfMode, Platform, PlacementMode

# enum value parity with PFAC.h
PFAC_PLATFORM_GPU = Platform.DEVICE
PFAC_PLATFORM_TPU = Platform.DEVICE
PFAC_PLATFORM_CPU = Platform.CPU
PFAC_PLATFORM_CPU_OMP = Platform.CPU_PARALLEL
PFAC_AUTOMATIC = PlacementMode.AUTO
PFAC_TEXTURE_ON = PlacementMode.VMEM
PFAC_TEXTURE_OFF = PlacementMode.HBM
PFAC_TIME_DRIVEN = PerfMode.DENSE
PFAC_SPACE_DRIVEN = PerfMode.HASH

PFAC_STATUS_SUCCESS = PfacStatus.SUCCESS
PFAC_STATUS_ALLOC_FAILED = PfacStatus.ALLOC_FAILED
PFAC_STATUS_CUDA_ALLOC_FAILED = PfacStatus.DEVICE_ALLOC_FAILED
PFAC_STATUS_INVALID_HANDLE = PfacStatus.INVALID_HANDLE
PFAC_STATUS_INVALID_PARAMETER = PfacStatus.INVALID_PARAMETER
PFAC_STATUS_PATTERNS_NOT_READY = PfacStatus.PATTERNS_NOT_READY
PFAC_STATUS_FILE_OPEN_ERROR = PfacStatus.FILE_OPEN_ERROR
PFAC_STATUS_LIB_NOT_EXIST = PfacStatus.LIB_NOT_EXIST
PFAC_STATUS_ARCH_MISMATCH = PfacStatus.ARCH_MISMATCH
PFAC_STATUS_MUTEX_ERROR = PfacStatus.MUTEX_ERROR
PFAC_STATUS_INTERNAL_ERROR = PfacStatus.INTERNAL_ERROR


class _Handle:
    """Mutable context: modes may be set before patterns are loaded."""

    def __init__(self, device="cuda"):
        self.device = device
        self.matcher: Matcher | None = None
        self.platform = Platform.DEVICE
        self.perf_mode = PerfMode.DENSE
        self.placement = PlacementMode.AUTO
        self.async_check = False    # see PFAC_setAsyncCheckMode


def PFAC_create(handle_out: MutableSequence, device="cuda") -> PfacStatus:
    """PFAC_create(&handle); `device` is the torch device of the handle's
    matcher (its kernels build at first use)."""
    if handle_out is None:
        return PfacStatus.INVALID_HANDLE
    handle_out.insert(0, _Handle(device))
    return PfacStatus.SUCCESS


def PFAC_destroy(handle: _Handle) -> PfacStatus:
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    handle.matcher = None
    return PfacStatus.SUCCESS


def PFAC_setPlatform(handle: _Handle, platform) -> PfacStatus:
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    try:
        handle.platform = Platform(int(platform))
    except ValueError:
        return PfacStatus.INVALID_PARAMETER
    if handle.matcher is not None:
        handle.matcher.set_platform(handle.platform)
    return PfacStatus.SUCCESS


def PFAC_setTextureMode(handle: _Handle, texture_mode) -> PfacStatus:
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    try:
        handle.placement = PlacementMode(int(texture_mode))
    except ValueError:
        return PfacStatus.INVALID_PARAMETER
    if handle.matcher is not None:
        handle.matcher.set_placement(handle.placement)
    return PfacStatus.SUCCESS


def PFAC_setPerfMode(handle: _Handle, perf_mode) -> PfacStatus:
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    try:
        handle.perf_mode = PerfMode(int(perf_mode))
    except ValueError:
        return PfacStatus.INVALID_PARAMETER
    if handle.matcher is not None:
        handle.matcher.set_perf_mode(handle.perf_mode)
    return PfacStatus.SUCCESS


def PFAC_getErrorString(status) -> str:
    from ..status import get_error_string

    return get_error_string(status)


def PFAC_readPatternFromFile(handle: _Handle, filename: str) -> PfacStatus:
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    if filename is None:
        return PfacStatus.INVALID_PARAMETER
    try:
        automaton = Automaton.from_pattern_file(filename)
        handle.matcher = Matcher(
            automaton=automaton,
            perf_mode=handle.perf_mode,
            platform=handle.platform,
            placement=handle.placement,
            device=handle.device,
        )
    except PfacError as e:
        return e.status
    except Exception:
        return PfacStatus.INTERNAL_ERROR
    return PfacStatus.SUCCESS


def PFAC_dumpTransitionTable(handle: _Handle, fp=None) -> PfacStatus:
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    if handle.matcher is None:
        return PfacStatus.PATTERNS_NOT_READY
    if fp is None:
        fp = sys.stdout
    try:
        handle.matcher.dump_transition_table(fp)
    except Exception:
        return PfacStatus.INTERNAL_ERROR
    return PfacStatus.SUCCESS


def PFAC_memoryUsage(handle: _Handle) -> PfacStatus:
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    if handle.matcher is None:
        return PfacStatus.PATTERNS_NOT_READY
    sys.stdout.write(handle.matcher.memory_usage())
    return PfacStatus.SUCCESS


def _match_common(handle, input_data, size, matched_result) -> PfacStatus:
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    if handle.matcher is None:
        return PfacStatus.PATTERNS_NOT_READY
    if input_data is None or matched_result is None:
        return PfacStatus.INVALID_PARAMETER
    if size == 0:
        return PfacStatus.SUCCESS
    try:
        result = handle.matcher.match(input_data[:size])
        matched_result[: len(result)] = result
    except PfacError as e:
        return e.status
    except Exception:
        return PfacStatus.INTERNAL_ERROR
    return PfacStatus.SUCCESS


def PFAC_matchFromHost(handle, h_input, size, h_matched_result) -> PfacStatus:
    """Host bytes in, IDs written into h_matched_result[:size]."""
    return _match_common(handle, h_input, size, h_matched_result)


def PFAC_matchFromDevice(handle, d_input, size, d_matched_result) -> PfacStatus:
    """Device-tensor variant: d_input is a uint8 tensor on the handle's
    device; the padded int32 result is inserted into the list-like cell
    d_matched_result (the engine allocates it).
    """
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    if handle.matcher is None:
        return PfacStatus.PATTERNS_NOT_READY
    if d_input is None or d_matched_result is None:
        return PfacStatus.INVALID_PARAMETER
    if size == 0:
        return PfacStatus.SUCCESS
    try:
        out = handle.matcher.match_device(d_input)
        # errors are reported per call, as the C library does: flush the
        # engine's deferred checks so SUCCESS here means `out` is complete.
        # PFAC_setAsyncCheckMode(handle, True) opts out of the per-call
        # flush; errors then surface at PFAC_synchronize instead.
        if not handle.async_check:
            handle.matcher.flush_checks()
        d_matched_result.insert(0, out)
    except PfacError as e:
        return e.status
    except Exception:
        return PfacStatus.INTERNAL_ERROR
    return PfacStatus.SUCCESS


def PFAC_matchFromHostReduce(
    handle, h_input, size, h_matched_result, h_pos, h_num_matched: MutableSequence
) -> PfacStatus:
    """Writes the compacted (id, pos) pairs into the first `count` slots,
    count into h_num_matched[0].
    """
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    if handle.matcher is None:
        return PfacStatus.PATTERNS_NOT_READY
    if h_input is None or h_matched_result is None or h_pos is None or h_num_matched is None:
        return PfacStatus.INVALID_PARAMETER
    if size == 0:
        return PfacStatus.SUCCESS
    try:
        ids, pos, count = handle.matcher.match_reduce(h_input[:size])
        h_matched_result[:count] = ids
        h_pos[:count] = pos
        h_num_matched.insert(0, count)
    except PfacError as e:
        return e.status
    except Exception:
        return PfacStatus.INTERNAL_ERROR
    return PfacStatus.SUCCESS


def PFAC_matchFromDeviceReduce(
    handle, d_input, size, d_matched_result: MutableSequence,
    d_pos: MutableSequence, h_num_matched: MutableSequence
) -> PfacStatus:
    """Device-resident compacted match: the ids and positions tensors go
    into the cells d_matched_result and d_pos; the count is read to the
    host (the one synchronisation of this call) into h_num_matched.

    With PFAC_setAsyncCheckMode(handle, True), a SUCCESS return is
    PROVISIONAL: the buffers and h_num_matched may reflect a truncated
    result while an overflow error is still pending on the dispatch
    stream. Callers must not act on the count or buffers until a later
    PFAC_synchronize(handle) returns SUCCESS (at which point every result
    handed out since the previous synchronize is confirmed complete).
    """
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    if handle.matcher is None:
        return PfacStatus.PATTERNS_NOT_READY
    if d_input is None:
        return PfacStatus.INVALID_PARAMETER
    if size == 0:
        return PfacStatus.SUCCESS
    try:
        ids, pos, count = handle.matcher.match_reduce_device(d_input)
        if not handle.async_check:      # per-call error discipline (see above)
            handle.matcher.flush_checks()
        d_matched_result.insert(0, ids)
        d_pos.insert(0, pos)
        h_num_matched.insert(0, int(count))
    except PfacError as e:
        return e.status
    except Exception:
        return PfacStatus.INTERNAL_ERROR
    return PfacStatus.SUCCESS


def PFAC_setAsyncCheckMode(handle: _Handle, enabled: bool) -> PfacStatus:
    """Opt out of the per-call deferred-error flush in
    PFAC_matchFromDevice[Reduce]. With async checks enabled, deferred
    errors surface at the next PFAC_synchronize (or a host-materializing
    call) instead. No C library analog (it synced per call).

    CONTRACT: while async checks are on, every result (and reduce count)
    returned by PFAC_matchFromDevice[Reduce] is PROVISIONAL until the
    next PFAC_synchronize succeeds; a pending overflow means those
    results may be incomplete and must be recomputed after the error is
    handled."""
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    handle.async_check = bool(enabled)
    return PfacStatus.SUCCESS


def PFAC_synchronize(handle: _Handle) -> PfacStatus:
    """Flush deferred device-path error checks (no C library analog: it
    reported errors per call because every call synced). Any
    error deferred by earlier PFAC_matchFromDevice[Reduce] calls made
    through a raw engine surfaces here as its status code."""
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    if handle.matcher is None:
        return PfacStatus.SUCCESS
    try:
        handle.matcher.flush_checks()
    except PfacError as e:
        return e.status
    except Exception:
        return PfacStatus.INTERNAL_ERROR
    return PfacStatus.SUCCESS

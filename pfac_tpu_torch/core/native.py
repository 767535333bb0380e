"""ctypes bindings for the native host compiler (``native/pfac_host.cpp``).

The port's own copy of ``pfac_tpu.core.native``: it builds the port's copy
of the C++ source into ``pfac_tpu_torch/_build/`` (git-ignored), so nothing
is written into the reference package's directory.

The C++ library accelerates the two build-time hot loops — pattern
compilation (parse/sort/trie) and the CHD displacement search — while the
pure-Python implementations in parser.py/trie.py/chd.py remain the
behavioral oracle; tests assert bit-identical outputs.

The shared library is built on demand with g++ (no pip deps). If the
toolchain or build is unavailable, everything transparently falls back to
Python — `native_available()` reports which path is active.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "pfac_host.cpp")
_SO = os.path.join(_PKG, "_build", "libpfac_host.so")


class _CompileResult(ctypes.Structure):
    _fields_ = [
        ("edges", ctypes.POINTER(ctypes.c_int32)),
        ("num_edges", ctypes.c_int64),
        ("pat_offset", ctypes.POINTER(ctypes.c_int32)),
        ("pat_id", ctypes.POINTER(ctypes.c_int32)),
        ("pat_len_by_id", ctypes.POINTER(ctypes.c_int32)),
        ("num_patterns", ctypes.c_int32),
        ("num_states", ctypes.c_int32),
        ("initial_state", ctypes.c_int32),
        ("num_leaves", ctypes.c_int32),
        ("status", ctypes.c_int32),
    ]


def _build_library() -> str | None:
    src = os.path.abspath(_SRC)
    so = os.path.abspath(_SO)
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    # build under a private name and rename: concurrent processes never
    # load a half-written library
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(so), exist_ok=True)
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp, src],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)
        return so
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return None


@functools.lru_cache(maxsize=1)
def _load():
    with _LOCK:
        so = _build_library()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        try:
            # ABI gate FIRST: a stale prebuilt .so (mtime >= source but an
            # old ABI) must fall back to Python, not raise AttributeError
            # out of the transparent-fallback contract when binding symbols
            # the old ABI lacks (e.g. chd_assign_fused, ABI v2+).
            lib.pfac_host_abi_version.restype = ctypes.c_int
            if lib.pfac_host_abi_version() != 2:
                return None
            lib.pfac_compile.restype = ctypes.POINTER(_CompileResult)
            lib.pfac_compile.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.pfac_compile_free.argtypes = [ctypes.POINTER(_CompileResult)]
            lib.chd_assign.restype = ctypes.c_int
            lib.chd_assign_fused.restype = ctypes.c_int
            lib.chd_assign_fused.argtypes = lib.chd_assign.argtypes = [
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_uint32,
                ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int32),
            ]
        except AttributeError:
            return None
        return lib


def native_available() -> bool:
    return _load() is not None


def compile_patterns(data: bytes):
    """Native parse+sort+trie. Returns None if the library is unavailable;
    otherwise a dict mirroring the Python compiler's outputs."""
    lib = _load()
    if lib is None:
        return None
    res = lib.pfac_compile(data, len(data))
    if not res:
        return None
    try:
        r = res.contents
        if r.status != 0:
            return {"error": int(r.status)}
        k = int(r.num_patterns)
        ne = int(r.num_edges)
        edges = np.ctypeslib.as_array(r.edges, shape=(ne * 3,)).reshape(ne, 3).copy()
        out = {
            "edges": edges,
            "pat_offset": np.ctypeslib.as_array(r.pat_offset, shape=(k,)).copy(),
            "pat_id": np.ctypeslib.as_array(r.pat_id, shape=(k,)).copy(),
            "pat_len_by_id": np.ctypeslib.as_array(r.pat_len_by_id, shape=(k + 1,)).copy(),
            "num_patterns": k,
            "num_states": int(r.num_states),
            "initial_state": int(r.initial_state),
            "num_leaves": int(r.num_leaves),
        }
        return out
    finally:
        lib.pfac_compile_free(res)


def chd_assign(keys: np.ndarray, r: int, b: int, slot_mul: int,
               fused: bool = False):
    """Native CHD displacement search; returns (disp, slot_of) or None
    (None also signals 'infeasible for this (r, b, salt)')."""
    lib = _load()
    if lib is None or (fused and not hasattr(lib, "chd_assign_fused")):
        return NotImplemented  # caller falls back to Python
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    disp = np.zeros(b, dtype=np.uint16)
    slot_of = np.zeros(keys.shape[0], dtype=np.int32)
    fn = lib.chd_assign_fused if fused else lib.chd_assign
    rc = fn(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        keys.shape[0], r, b, ctypes.c_uint32(slot_mul),
        disp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        slot_of.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        return None
    return disp, slot_of.astype(np.int64)

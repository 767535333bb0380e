"""Build and load the CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface. Each source is compiled by its own
``nvcc`` process, all started together, and the objects are linked into one
shared library, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o _build/<source>.o csrc/<source>.cu   # each
    nvcc -shared -o _build/libpfac_kernels.so _build/*.o

The build runs at first use, once per process (lock + cache, as
``core.native`` does for the host library), into ``_build/`` beside this
file, and is redone whenever a source is newer than the library. It
writes to a temporary name and renames, so concurrent processes never load
a half-written library. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import subprocess
import threading

from . import trace

_LOCK = threading.Lock()
_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
LIB = os.path.join(BUILD_DIR, "libpfac_kernels.so")
ARCH = "arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int32
_SIGNATURES = {
    # device, data, n, npad, arena, words, res_off, desc, placement, match,
    # bits, counts, block, stream
    "pfac_sieve": [ctypes.c_int, _P, _I, _I, _P, _I, _I, _P, _I, _P, _P, _P,
                   _I, _P],
    # device, counts, nblocks, thresh, offsets, counters, stream
    "pfac_compact_scan": [ctypes.c_int, _P, _I, _I, _P, _P, _P],
    # device, bits, counts, offsets, nblocks, block, thresh, pos, counters,
    # stream
    "pfac_compact": [ctypes.c_int, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # device, result, npad, ids, pos, count, status, nstatus, epoch, stream
    "pfac_reduce": [ctypes.c_int, _P, _I, _P, _P, _P, _P, ctypes.c_int64,
                    ctypes.c_uint32, _P],
    # device, data, n, pos, count, cap, arena, words, resident, records,
    # nsteps, out, stream
    "pfac_walk": [ctypes.c_int, _P, _I, _P, _P, _I, _P, _I, _I, _P, _I, _P,
                  _P],
    # device, nsteps, resident, words, grid
    "pfac_walk_grid": [ctypes.c_int, _I, _I, _I, _P],
    # device, data, n, counts, nblocks, block, thresh, arena, words,
    # resident, desc, nsteps, look, cap, out, stream
    "pfac_block_walk": [ctypes.c_int, _P, _I, _P, _I, _I, _I, _P, _I, _I, _P,
                        _I, _I, _I, _P, _P],
    # device, data, n, pos, count, cap, arena, desc, nsteps, out, stream
    "pfac_csr_walk": [ctypes.c_int, _P, _I, _P, _P, _I, _P, _P, _I, _P, _P],
    # device, nsteps, grid
    "pfac_csr_walk_grid": [ctypes.c_int, _I, _P],
    # device, table, words, idx, n, placement, out, stream
    "pfac_word_gather": [ctypes.c_int, _P, _I, _P, _I, _I, _P, _P],
    # device, tile, rows, cols, idx, m, k, axis, direct, out, stream
    "pfac_tile_gather": [ctypes.c_int, _P, _I, _I, _P, _I, _I, _I, _I, _P,
                         _P],
    # device, table, words, idx, n, chain, placement, hashed, out, stream
    "pfac_chain_gather": [ctypes.c_int, _P, _I, _P, _I, _I, _I, _I, _P, _P],
    # device, pos, raw, groups, w_out, w_raw, out, stream
    "pfac_align": [ctypes.c_int, _P, _P, _I, _I, _I, _P, _P],
    # device, r, len, stride, nseg, out, stream
    "pfac_count": [ctypes.c_int, _P, ctypes.c_int64, ctypes.c_int64, _I, _P,
                   _P],
    # device, data, n, npad, pair_state, pair_match, form, form_words,
    # hashed, t0..t3, num_final, max_len, out, stream
    "pfac_lockstep": [ctypes.c_int, _P, ctypes.c_int64, ctypes.c_int64, _P,
                      _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P],
    # spec, data[], n[], result, scratch, status, nstatus, epoch, count_len,
    # program (out)
    "pfac_program_create": [_P, _P, _P, _P, _P, _P, ctypes.c_int64,
                            ctypes.c_uint32, ctypes.c_int64, _P],
    # program, data, n, result, scratch, status, nstatus, epoch, stream
    "pfac_program_launch": [_P, _P, _I, _P, _P, _P, ctypes.c_int64,
                            ctypes.c_uint32, _P],
    # program, data[], n[], result, scratch, count_len, stream
    "pfac_program_launch_shards": [_P, _P, _P, _P, _P, ctypes.c_int64, _P],
    # program
    "pfac_program_destroy": [_P],
}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else the one PyTorch finds."""
    home = os.environ.get("CUDA_HOME")
    if home is None:
        from torch.utils.cpp_extension import CUDA_HOME
        home = CUDA_HOME
    path = os.path.join(home, "bin", "nvcc") if home else shutil.which("nvcc")
    if not path or not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return path


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(LIB):
        return True
    deps = sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return max(os.path.getmtime(p) for p in deps) > os.path.getmtime(LIB)


def build(verbose: bool = False) -> str:
    """Compile the kernels unless the library is current; -> its path."""
    if not _stale():
        return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            for src in sources()]
    flags = ["-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    if verbose:
        flags.append("-Xptxas=-v")
    procs = [subprocess.Popen([nvcc(), *flags, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for src, obj in zip(sources(), objs)]
    try:
        logs = []
        for src, proc in zip(sources(), procs):
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} "
                                   f"({proc.returncode}):\n{err}")
            logs.append(err)
        tmp = f"{LIB}.{tag}"
        res = subprocess.run([nvcc(), "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(tmp, LIB)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    if verbose:
        print("".join(logs), end="")
    return LIB


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build if needed and load the library with its signatures set (its
    seconds: ``build.library_s`` in ``trace``)."""
    with trace.timed("build.library_s"), _LOCK:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def check(rc: int, kernel: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {rc}")

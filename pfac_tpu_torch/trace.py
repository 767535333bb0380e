"""The port's spans and counters: one registry for the whole process.

**Spans.** :func:`span` (a context manager) and :func:`spanned` (a
decorator, for the request's hot path) mark a layer of the call with
``torch.profiler``'s fast record function, and only while the profiler
records: otherwise they cost one flag read. The profiler keeps the spans
with the card's timeline, so the host's layers and the kernels share one
clock; nothing here writes a file. The spans on the request's path:

* ``pfac.match_device``, ``pfac.match_reduce_device``: the handle
  (``runtime/handle.py``), the request's outermost span;
* ``pfac.sieve_engine``: ``SieveMatcher._run``;
* ``pfac.program``: ``program.match`` and ``program.match_shards``; inside
  it the profiler records the node updates, ``cudaMemsetAsync`` and
  ``cudaGraphLaunch``, whose correlation id the graph's kernels carry;
* ``pfac.program.build``: a program's geometry and graph, built at a new
  ``(device, npad, ...)``.

While the profiler records, each span also adds its count and host seconds
to ``span.<name>.calls`` and ``span.<name>.s``.

**Counters** (:func:`counters`, :func:`reset`), read only where asked:

* ``launch.<kernel>``: each kernel's launches (every wrapper counts its
  own; a program counts its calls once and its kernels are its calls
  times its fixed kernel list, expanded when the counters are read);
  ``launch.program``: program launches (one a call, one a device of a
  sharded call);
* ``positions``: the positions the programs scanned (npad a shard);
* ``walk.whole_calls``, ``walk.split_calls``: the program calls on the
  walk-table tier whose K2 holds the whole walk tables in shared
  memory, and those whose K2 holds a prefix and reads the rest through
  L1/L2 (``backends/walk.py::launch_plan``);
* ``build.programs``, ``build.program_s``: programs built, and the host
  seconds their geometry and graphs took;
* ``build.library_s``: the kernels' library built or loaded
  (``_build.load``); ``build.automaton_s``, ``build.tables_s``,
  ``build.upload_s``: the handle's automaton, the engine's host tables and
  their copy to the device.

**Device counters** (:func:`device_counters`): every program on a device
adds to that device's eight int64 words on the card (no graph node, no
host wait): ``survivors``, the positions K1 let through to the walker (the
scan's total), and ``blocks_escaped``, the blocks K3 walked whole, one
atomic each a call from ``compact_scan_kernel``; ``short_probes``, the m2
and m3 key probes K1 issued (0-2 a position: only where the position's
first byte starts a 2- or 3-byte pattern), one atomic a CTA of K1;
``walk_steps``, the loop iterations in which a lane of K2 had a walk (the
entry probe counts as one: the walk work the survivors needed), and
``walk_slots``, each of K2's warps' iterations times 32 (the lane slots
its grid spent), one atomic each a CTA of K2; ``block_walk_probes``, the
exact-table probes K3 issued (a dead position's in a batch included: the
work its batching spends), and ``block_walk_positions``, the positions
below n of the tiles K3 walked, one atomic each a CTA of K3 that walked
a tile; ``compact_wordwise_chunks``, the 32-word chunks of the bitmap
that ``compact_kernel`` listed word by word (the nonempty chunks of a
warp's round of more than 509 survivors: the escape disarmed, as on the
CSR tier), one atomic a CTA that listed any. The CSR
walk counts no steps, and the per-kernel wrappers count
nothing. Each kernel finds its words by their offsets in the program's
``Spec`` (``backends/program.py::counter_words``), so their order is
written here alone. Reading them copies the words of each device to the
host, the one read here that waits for the card.
"""
from __future__ import annotations

import contextlib
import functools
import time
from collections import Counter, defaultdict

import torch
from torch.autograd import profiler as _prof

DEVICE_KEYS = ("survivors", "blocks_escaped", "short_probes", "walk_steps",
               "walk_slots", "block_walk_probes", "block_walk_positions",
               "compact_wordwise_chunks")

_COUNTS: defaultdict = defaultdict(int)
_TALLIES: dict[tuple, "Tally"] = {}
_DEVICE: dict[int, torch.Tensor] = {}      # device index -> int64[8]
_SPAN_KEYS: dict[str, tuple[str, str]] = {}


class Tally:
    """What one call of a fixed plan adds to the counters (`adds`, pairs
    of key and amount); a call adds 1 to `calls` and nothing else."""

    __slots__ = ("adds", "calls")

    def __init__(self, adds: tuple[tuple[str, int], ...]):
        self.adds, self.calls = adds, 0


def tally(adds: dict[str, int]) -> Tally:
    """The registry's tally for `adds` (one for equal plans)."""
    key = tuple(sorted(adds.items()))
    got = _TALLIES.get(key)
    return got if got is not None else _TALLIES.setdefault(key, Tally(key))


def count(key: str, k: int | float = 1) -> None:
    _COUNTS[key] += k


@contextlib.contextmanager
def timed(key: str):
    """Adds the host seconds of the block to the counter `key`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _COUNTS[key] += time.perf_counter() - t0


def counters() -> Counter:
    """Every host counter (a missing key reads 0); never waits for the
    card."""
    out = Counter(_COUNTS)
    for t in _TALLIES.values():
        if t.calls:
            for key, k in t.adds:
                out[key] += k * t.calls
    return out


def launches(*kernels: str) -> dict[str, int]:
    """``{kernel: launches}`` for the kernels named."""
    c = counters()
    return {k: c[f"launch.{k}"] for k in kernels}


def device_buffer(device: torch.device) -> torch.Tensor:
    """The device's counter words (int64[8], :data:`DEVICE_KEYS`), made
    zero at the first use; they live as long as the process."""
    index = device.index or 0
    buf = _DEVICE.get(index)
    if buf is None:
        buf = _DEVICE.setdefault(
            index, torch.zeros(len(DEVICE_KEYS), dtype=torch.int64,
                               device=device))
    return buf


def device_counters() -> dict[str, int]:
    """The device counters summed over the devices, copied to the host
    (this waits for each device's work so far)."""
    out = dict.fromkeys(DEVICE_KEYS, 0)
    for buf in list(_DEVICE.values()):
        for key, v in zip(DEVICE_KEYS, buf.tolist()):
            out[key] += v
    return out


def reset() -> None:
    """Every counter to 0, the device counters too (queued on each device's
    current stream)."""
    _COUNTS.clear()
    for t in _TALLIES.values():
        t.calls = 0
    for index, buf in _DEVICE.items():
        with torch.cuda.device(index):
            buf.zero_()


def recording() -> bool:
    """Whether ``torch.profiler`` records (one module flag read)."""
    return _prof._is_profiler_enabled


class _Span:
    __slots__ = ("rf", "keys", "t0")

    def __init__(self, name: str):
        self.rf = torch._C._profiler._RecordFunctionFast(name)
        keys = _SPAN_KEYS.get(name)
        if keys is None:
            keys = _SPAN_KEYS[name] = (f"span.{name}.calls",
                                       f"span.{name}.s")
        self.keys = keys

    def __enter__(self):
        self.rf.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        _COUNTS[self.keys[1]] += time.perf_counter() - self.t0
        _COUNTS[self.keys[0]] += 1
        return self.rf.__exit__(*exc)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_NO_SPAN = _NoSpan()


def span(name: str):
    """A span named `name` while the profiler records, else a shared
    no-op."""
    return _Span(name) if _prof._is_profiler_enabled else _NO_SPAN


def spanned(name: str):
    """Decorator: the function's calls as spans named `name`; with the
    profiler off, one flag read and the call (cheaper than ``with
    span(...)``: no context manager)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if not _prof._is_profiler_enabled:
                return fn(*args, **kw)
            with _Span(name):
                return fn(*args, **kw)
        return call
    return wrap

"""pfac-tpu on PyTorch and CUDA: exact multi-pattern matching (Parallel
Failureless Aho-Corasick) with hand-written Hopper kernels.

A port of :mod:`pfac_tpu` beside it, with the same :class:`Matcher` API plus
an explicit torch ``device``. It keeps its own copies of the reference's
numpy host layers (automaton compiler, status codes, golden model,
``StreamMatcher``) and imports neither JAX nor :mod:`pfac_tpu`.

    >>> import pfac_tpu_torch as pt
    >>> pt.Matcher([b"AB", b"ABG", b"BEDE", b"ED"], device="cpu").match(
    ...     b"ABEDEDABG").tolist()
    [1, 3, 4, 0, 4, 0, 2, 0, 0]
"""
from .core import Automaton
from .runtime.handle import Backend, Matcher, PerfMode, PlacementMode, Platform
from .status import PfacError, PfacStatus, get_error_string

__all__ = [
    "Automaton",
    "Backend",
    "Matcher",
    "PerfMode",
    "PfacError",
    "PfacStatus",
    "PlacementMode",
    "Platform",
    "get_error_string",
]

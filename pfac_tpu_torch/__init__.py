"""pfac-tpu on PyTorch and CUDA: exact multi-pattern matching (Parallel
Failureless Aho-Corasick) with hand-written Hopper kernels.

A port of :mod:`pfac_tpu` beside it, with the same :class:`Matcher` API plus
an explicit torch ``device``, and the same exports. It keeps its own copies
of the reference's numpy host layers (automaton compiler, status codes,
golden model, ``StreamMatcher``) and imports neither JAX nor
:mod:`pfac_tpu`. The C-style API is ``pfac_tpu_torch.runtime.capi``; the
CLI and the on-device fuzz are ``pfac_tpu_torch.tools.cli`` and
``pfac_tpu_torch.tools.device_fuzz``.

    >>> import pfac_tpu_torch as pt
    >>> pt.Matcher([b"AB", b"ABG", b"BEDE", b"ED"], device="cpu").match(
    ...     b"ABEDEDABG").tolist()
    [1, 3, 4, 0, 4, 0, 2, 0, 0]
"""
from .core import Automaton
from .core.parser import (ParsedPatterns, parse_pattern_bytes,
                          parse_pattern_file, patterns_from_list)
from .runtime.handle import Backend, Matcher, PerfMode, PlacementMode, Platform
from .runtime.stream import StreamMatcher
from .status import PfacError, PfacStatus, get_error_string

__version__ = "0.1.0"

__all__ = [
    "Automaton",
    "Backend",
    "Matcher",
    "ParsedPatterns",
    "PerfMode",
    "PfacError",
    "PfacStatus",
    "PlacementMode",
    "Platform",
    "StreamMatcher",
    "get_error_string",
    "parse_pattern_bytes",
    "parse_pattern_file",
    "patterns_from_list",
]

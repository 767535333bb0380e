"""Pattern-file parsing and lexicographic reordering.

Behavioral contract mirrors the reference host compiler
(reference: PFAC/src/PFAC_reorder_Table.cpp:121-231):

* Patterns are newline-delimited byte strings; pattern IDs 1..k are assigned
  by **file order of non-empty lines**.
* A final line with no trailing ``\\n`` is ignored (the reference only emits a
  pattern when it sees the terminating newline,
  PFAC_reorder_Table.cpp:181-193).
* Empty lines produce no pattern and consume no ID.  (The reference skips the
  ID but leaves a stale string pointer for files with interior empty lines —
  undefined behavior there; we implement the evident intent: skip.)
* Patterns are then sorted lexicographically with prefix-first tie-breaking
  (PFAC_reorder_Table.cpp:37-72).  Python's ``bytes`` ordering is exactly
  that ordering, and ``sorted`` is stable, matching the reference's intent
  for duplicates.
* After sorting, ``pattern_ids[i]`` is the original 1-based ID of the i-th
  sorted pattern, and ``pattern_lens[id]`` is the length of pattern ``id``
  with ``pattern_lens[0] = 0`` unused (PFAC_reorder_Table.cpp:204-228).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..status import PfacError, PfacStatus


@dataclasses.dataclass(frozen=True)
class ParsedPatterns:
    """Result of parsing + reordering a pattern set."""

    #: patterns in sorted (lexicographic, prefix-first) order
    sorted_patterns: tuple[bytes, ...]
    #: original 1-based pattern ID for each sorted index, int32[k]
    pattern_ids: np.ndarray
    #: length of pattern with ID i at index i; index 0 unused (=0), int32[k+1]
    pattern_lens: np.ndarray
    #: upper bound on DFA state count (= pattern bytes + 2; reference uses
    #: file_size + 1 where file_size includes newlines)
    max_state_num: int

    @property
    def num_patterns(self) -> int:
        return len(self.sorted_patterns)

    @property
    def max_pattern_len(self) -> int:
        # reference computes max over patternLen_table (PFAC/src/PFAC.cpp:687-691)
        return int(self.pattern_lens.max()) if self.num_patterns else 0


def parse_pattern_bytes(data: bytes) -> ParsedPatterns:
    """Parse a pattern buffer (the in-memory equivalent of the pattern file)."""
    patterns: list[bytes] = []
    start = 0
    n = len(data)
    for i in range(n):
        if data[i] == 0x0A:  # '\n'
            if i > start:
                patterns.append(data[start:i])
            start = i + 1
    # trailing content without '\n' is ignored, matching the reference
    return patterns_from_list(patterns, _max_state_hint=n + 1)


def parse_pattern_file(path: str) -> ParsedPatterns:
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise PfacError(PfacStatus.FILE_OPEN_ERROR, str(e)) from e
    return parse_pattern_bytes(data)


def patterns_from_list(
    patterns: Sequence[bytes], *, _max_state_hint: int | None = None
) -> ParsedPatterns:
    """Build a ParsedPatterns from an explicit list (IDs = 1-based list order).

    This is the pythonic entry point the C library never had: callers can pass
    patterns directly instead of round-tripping through a file. Unlike the
    newline-delimited file format, patterns here may contain any byte value,
    including 0x0A.
    """
    pats = []
    for p in patterns:
        if isinstance(p, str):
            p = p.encode("utf-8")
        if not isinstance(p, (bytes, bytearray)):
            raise PfacError(PfacStatus.INVALID_PARAMETER, f"pattern of type {type(p)!r}")
        if len(p) == 0:
            raise PfacError(PfacStatus.INVALID_PARAMETER, "empty pattern")
        pats.append(bytes(p))

    k = len(pats)
    order = sorted(range(k), key=lambda i: pats[i])
    sorted_patterns = tuple(pats[i] for i in order)
    pattern_ids = np.asarray([i + 1 for i in order], dtype=np.int32)
    pattern_lens = np.zeros(k + 1, dtype=np.int32)
    for i, p in enumerate(pats):
        pattern_lens[i + 1] = len(p)

    if _max_state_hint is None:
        # pattern bytes + newlines + 1, same bound as the reference's file_size+1
        _max_state_hint = sum(len(p) + 1 for p in pats) + 1
    return ParsedPatterns(
        sorted_patterns=sorted_patterns,
        pattern_ids=pattern_ids,
        pattern_lens=pattern_lens,
        max_state_num=_max_state_hint,
    )

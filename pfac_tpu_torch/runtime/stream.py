"""Streaming matcher: exact matching over a corpus fed in chunks (a copy
of ``pfac_tpu.runtime.stream``).

The reference library only matches whole buffers; cross-boundary matches
in its multi-GPU harness are handled by re-reading guard bytes
(reference: PFAC/test/omp_PFAC.cpp:317-383). This streaming surface makes
that first-class for single-stream consumers (e.g. scanning a file or a
network flow without materializing it):

    sm = StreamMatcher(matcher)
    for chunk in chunks:
        for start, ids in [sm.feed(chunk)]:
            ...            # ids[i] = match at global position start + i
    start, ids = sm.finish()

Exactness: a position's result is FINAL once `max_pattern_len` bytes
beyond it are available, so `feed` returns results only for the prefix
whose windows fit entirely in (carry + chunk); the last
``max_pattern_len - 1`` bytes carry over. Concatenating everything feed()
and finish() return equals matching the whole stream at once.
"""
from __future__ import annotations

import numpy as np

from ..status import PfacError, PfacStatus


class StreamMatcher:
    """Wraps any matcher exposing ``match(bytes) -> np.ndarray`` and
    ``automaton.max_pattern_len`` (Matcher, SieveMatcher, XlaMatcher...)."""

    def __init__(self, matcher, *, min_batch: int = 1 << 20):
        self.matcher = matcher
        self.max_len = int(matcher.automaton.max_pattern_len)
        #: buffer small feeds until at least this many bytes are pending
        #: (device dispatch has fixed cost; tiny chunks would be slow)
        self.min_batch = min_batch
        self._carry = b""
        self._pos = 0          # global position of the first carry byte
        self._finished = False

    def feed(self, chunk: bytes) -> tuple[int, np.ndarray]:
        """Consume a chunk; return (start, ids) for newly-final positions.

        ``ids`` may be empty when not enough bytes are pending yet.
        """
        if self._finished:
            raise PfacError(PfacStatus.INVALID_PARAMETER,
                            "stream already finished")
        buf = self._carry + bytes(chunk)
        keep = len(buf) - (self.max_len - 1)
        if keep <= 0 or len(buf) < self.min_batch:
            self._carry = buf
            return self._pos, np.zeros(0, dtype=np.int32)
        # positions [0, keep) have full lookahead windows inside buf, so
        # matching buf alone gives their exact final results
        out = self.matcher.match(buf)[:keep]
        start = self._pos
        self._carry = buf[keep:]
        self._pos += keep
        return start, out

    def finish(self) -> tuple[int, np.ndarray]:
        """Flush: results for all remaining (end-of-stream) positions."""
        if self._finished:
            raise PfacError(PfacStatus.INVALID_PARAMETER,
                            "stream already finished")
        self._finished = True
        start = self._pos
        if not self._carry:
            return start, np.zeros(0, dtype=np.int32)
        out = self.matcher.match(self._carry)
        self._carry = b""
        self._pos = start + out.shape[0]
        return start, out

"""Failureless Aho-Corasick trie / DFA construction.

Mirrors the reference builder (reference:
PFAC/src/PFAC_reorder_Table.cpp:256-329) exactly in its observable output:

* State numbering: final states are 1..k (final state number == original
  pattern ID), state 0 is unused (we repurpose it as the device-side trap),
  the initial state is k+1, and interior states are allocated from k+2
  upward in insertion order (PFAC/src/PFAC.cpp:693,703).
* Patterns are inserted in sorted (prefix-first) order, so when pattern P is
  a prefix of pattern Q, P's final state is created first and then reused as
  an interior node on Q's path — final states can have outgoing transitions.
* The "is final?" test downstream is simply ``1 <= state <= k``.

The compact table preserves per-state insertion order of transitions so the
human-readable dump (`dump_transition_table`) matches the reference's.
"""
from __future__ import annotations

import dataclasses

from ..status import PfacError, PfacStatus
from .parser import ParsedPatterns

#: reference trap sentinel is 0xFFFFFFFF stored in int32 == -1
#: (PFAC/include/PFAC_P.h:181-182); we use -1 in host tables.
TRAP_STATE = -1
CHAR_SET = 256


@dataclasses.dataclass
class CompactTrie:
    """Adjacency-list DFA: rows[s] = [(ch, next_state), ...] in insertion order."""

    rows: list[list[tuple[int, int]]]
    num_states: int          # total allocated state slots (incl. unused state 0)
    num_final_states: int    # == number of patterns k
    initial_state: int       # == k + 1
    num_leaves: int          # patterns that are not a proper prefix of another

    #: optional cached (E, 3) int32 edge array (state, ch, next)
    _edges: "object" = None

    def lookup(self, state: int, ch: int) -> int:
        if state >= len(self.rows):
            return TRAP_STATE
        for c, nxt in self.rows[state]:
            if c == ch:
                return nxt
        return TRAP_STATE

    def edges_array(self):
        """All transitions as an int32 [E, 3] array of (state, ch, next)."""
        import numpy as np

        if self._edges is None:
            trip = [
                (s, ch, nxt)
                for s, row in enumerate(self.rows)
                for ch, nxt in row
            ]
            self._edges = np.asarray(trip, dtype=np.int32).reshape(-1, 3)
        return self._edges


def build_trie(parsed: ParsedPatterns) -> CompactTrie:
    k = parsed.num_patterns
    initial_state = k + 1
    base_usable = initial_state + 1
    max_state_num = max(parsed.max_state_num, base_usable + 1)

    rows: list[list[tuple[int, int]]] = [[] for _ in range(max_state_num)]
    # dict mirror of `rows` for O(1) lookup; first insertion wins, matching
    # the reference's linear-scan `lookup` (PFAC_reorder_Table.cpp:234-244)
    maps: list[dict[int, int]] = [dict() for _ in range(max_state_num)]

    state_num = base_usable
    for p_idx in range(k):
        pattern = parsed.sorted_patterns[p_idx]
        pattern_id = int(parsed.pattern_ids[p_idx])
        plen = int(parsed.pattern_lens[pattern_id])
        state = initial_state
        for offset in range(plen):
            ch = pattern[offset]
            if offset == plen - 1:
                # final char: transition straight to the final state (== ID).
                # Duplicate patterns hit an existing (state, ch) edge here; the
                # reference appends a second entry whose later dense-table fill
                # overwrites the first (and whose hash build then fails — dup
                # patterns are UB there). We replace in place: same dense
                # semantics (last ID wins), and the hash stays well-defined.
                if ch in maps[state]:
                    rows[state] = [
                        (c, pattern_id if c == ch else n) for c, n in rows[state]
                    ]
                else:
                    rows[state].append((ch, pattern_id))
                maps[state][ch] = pattern_id
            else:
                nxt = maps[state].get(ch, TRAP_STATE)
                if nxt == TRAP_STATE:
                    rows[state].append((ch, state_num))
                    maps[state][ch] = state_num
                    state = state_num
                    state_num += 1
                else:
                    state = nxt
            if state_num > max_state_num:
                raise PfacError(
                    PfacStatus.INTERNAL_ERROR,
                    f"state overflow: {state_num} > {max_state_num}",
                )

    rows = rows[:state_num]

    # numOfLeaves: final states with no outgoing transitions
    # (reference: PFAC/src/PFAC.cpp:716-722)
    num_leaves = sum(1 for s in range(1, k + 1) if len(rows[s]) == 0)

    return CompactTrie(
        rows=rows,
        num_states=state_num,
        num_final_states=k,
        initial_state=initial_state,
        num_leaves=num_leaves,
    )

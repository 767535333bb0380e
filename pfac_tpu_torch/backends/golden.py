"""Serial NumPy golden model — the semantic oracle for every other backend.

Implements the exact per-start failureless walk of the reference CPU backend
(reference: PFAC/src/PFAC_CPU.cpp:60-163):

    for each start position i:
        state = initial_state
        for pos = i .. N-1:
            state = delta(state, input[pos])     # dense or hashed delta
            if state == trap: break
            if state <= num_final_states: result[i] = state   # longest wins

``match_result[i]`` is the ID of the longest pattern starting at byte ``i``
(0 if none) — the contract of `PFAC_matchFromHost`.

A copy of ``pfac_tpu.backends.golden``. Its two vectorized oracles:
``match_dense_batch`` walks the lockstep walker's dense device tables
(``xla.dense_device_table``, ``xla.pair_tables``: S x 257 int32, so a
Snort-scale ruleset); ``match_edges_batch`` binary-searches the trie's
sorted edge list, for rulesets whose dense table would not fit the host.
"""
from __future__ import annotations

import numpy as np

from ..core.automaton import Automaton
from ..core.tables import HASH_KEY_K_MASKBITS, HASH_KEY_S_MASK, HASH_P
from ..core.trie import TRAP_STATE


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data), dtype=np.uint8)
    arr = np.asarray(data)
    if arr.dtype != np.uint8:
        raise TypeError(f"expected bytes/uint8 array, got {arr.dtype}")
    return arr


def match_dense(automaton: Automaton, data) -> np.ndarray:
    """Serial dense-table matcher (reference: PFAC_CPU_timeDriven)."""
    inp = _as_u8(data)
    table = automaton.ensure_dense().table
    n = inp.shape[0]
    k = automaton.num_final_states
    result = np.zeros(n, dtype=np.int32)
    for start in range(n):
        state = automaton.initial_state
        for pos in range(start, n):
            state = int(table[state, inp[pos]])
            if state == TRAP_STATE:
                break
            if state <= k:
                result[start] = state
    return result


def match_hash(automaton: Automaton, data) -> np.ndarray:
    """Serial hashed-table matcher (reference: PFAC_CPU_spaceDriven)."""
    inp = _as_u8(data)
    ht = automaton.ensure_hash()
    row_ptr, val = ht.row_ptr, ht.val
    n = inp.shape[0]
    k = automaton.num_final_states
    result = np.zeros(n, dtype=np.int32)
    for start in range(n):
        state = automaton.initial_state
        for pos in range(start, n):
            ch_in = int(inp[pos])
            offset = int(row_ptr[state, 0])
            if offset < 0:
                break
            k_sminus1 = int(row_ptr[state, 1])
            sminus1 = k_sminus1 & HASH_KEY_S_MASK
            key = k_sminus1 >> HASH_KEY_K_MASKBITS
            x = key * ch_in
            beta = (x & 0xFF) - (x >> 8)
            if beta < 0:
                beta += HASH_P
            slot = offset + (beta & sminus1)
            if int(val[slot, 1]) != ch_in:
                break
            state = int(val[slot, 0])
            if state <= k:
                result[start] = state
    return result


def match_dense_batch(automaton: Automaton, data,
                      chunk: int = 1 << 22) -> np.ndarray:
    """Vectorized dense-table oracle: all starts walk in NumPy batches
    with active-set compaction (dead lanes drop out each step), so work
    is O(sum of walk lengths), not O(n * max_len). Bit-identical to
    match_dense; fast enough to verify a 128 MB corpus end to end."""
    from .xla import STRIDE, dense_device_table, pair_tables

    inp = _as_u8(data)
    n = inp.shape[0]
    a = automaton
    dev_flat = dense_device_table(a).reshape(-1)   # trap -> 0, col 256 trap
    ps, pm = pair_tables(a)                        # fused first-two-steps
    k = a.num_final_states
    ext = np.full(n + a.max_pattern_len + 1, 256, dtype=np.int32)
    ext[:n] = inp
    result = np.zeros(n, dtype=np.int32)
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        # steps 1-2 by the pair table: one gather ends most starts
        key = ext[c0:c1] * STRIDE + ext[c0 + 1:c1 + 1]       # int32 fits
        state = ps[key]
        result[c0:c1] = pm[key]
        alive = state > 0
        idx = (np.arange(c0, c1, dtype=np.int64)[alive]
               if n > (1 << 31) - 260 else
               np.arange(c0, c1, dtype=np.int32)[alive])
        state = state[alive]
        d = 2
        while idx.size and d < a.max_pattern_len:
            state = dev_flat[state * STRIDE + ext[idx + d]]
            hit = (state > 0) & (state <= k)
            result[idx[hit]] = state[hit]
            alive = state > 0
            idx, state = idx[alive], state[alive]
            d += 1
    return result


def match_edges_batch(automaton: Automaton, data,
                      chunk: int = 1 << 22) -> np.ndarray:
    """Vectorized oracle over the sorted EDGE LIST (binary search per
    transition): O(edges) memory instead of the dense S x 257 matrix.
    For 100K-signature rulesets (6M states) the dense oracle's table is
    ~6 GB; this one is ~240 MB of int64 keys. Bit-identical to
    match_dense / match_dense_batch (asserted in tests)."""
    inp = _as_u8(data)
    n = inp.shape[0]
    a = automaton
    if a.trie is None:
        raise ValueError("edge oracle needs the compiled trie")
    edges = a.trie.edges_array()              # (E, 3) int32: s, ch, next
    # radix 257, NOT 256: the end-of-input sentinel byte is 256, and with
    # radix 256 the probe key state*256 + 256 would alias
    # (state+1)*256 + 0x00 — a real NUL edge of the next state — letting
    # walks past the input end take false transitions (review repro:
    # binary rulesets with 0x00 edges mismatched the dense oracle near
    # the corpus tail)
    keys = edges[:, 0].astype(np.int64) * 257 + edges[:, 1]
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    nxt = edges[order, 2].astype(np.int64)
    k = a.num_final_states
    result = np.zeros(n, dtype=np.int32)
    ext = np.full(n + a.max_pattern_len + 1, 256, dtype=np.int64)
    ext[:n] = inp
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        idx = np.arange(c0, c1, dtype=np.int64)
        state = np.full(c1 - c0, a.initial_state, dtype=np.int64)
        d = 0
        while idx.size and d < a.max_pattern_len:
            q = state * 257 + ext[idx + d]
            p = np.searchsorted(keys, q)
            p = np.minimum(p, keys.shape[0] - 1)
            hit = keys[p] == q
            state = np.where(hit, nxt[p], 0)
            fin = (state > 0) & (state <= k)
            result[idx[fin]] = state[fin]
            alive = state > 0
            idx, state = idx[alive], state[alive]
            d += 1
    return result


def match(automaton: Automaton, data, perf_mode: str = "dense") -> np.ndarray:
    if perf_mode == "dense":
        return match_dense(automaton, data)
    if perf_mode == "hash":
        return match_hash(automaton, data)
    raise ValueError(f"unknown perf_mode {perf_mode!r}")


def reduce_result(match_result: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Compact a dense match result into (ids, positions, count), positions
    ascending — the `PFAC_matchFromHostReduce` output contract
    (reference: PFAC/src/PFAC.cpp:1060-1070)."""
    pos = np.nonzero(match_result > 0)[0].astype(np.int32)
    ids = match_result[pos].astype(np.int32)
    return ids, pos, int(pos.shape[0])

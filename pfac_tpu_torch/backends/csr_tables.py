"""Host tables of the CSR walk tier (the K4 counterpart, ``csr_walk.py``).

Counterpart of ``pfac_tpu.backends.xla_csr.CsrStep``, ``CsrTables`` and
``build_csr_tables``. That module imports JAX, so its numpy builder is
copied here; its arrays come out equal to the reference's (entry rows,
``entry_lgb``, ``entry_width``, per-step rows, ``chain``, ``max_len``).
The build gives the same result with less Python work: patterns are grouped
by length once, the live prefix set shrinks with depth, and the rows are
filled by one numpy scatter per step.

Serves rulesets the walk tables cannot encode (pattern IDs or per-depth
state counts >= 2^16) or whose walk tables exceed their 6 MB budget, such as
100K ClamAV-scale signature sets.

* Depth-4 prefixes get 1-based indices (0 = no state). The entry is a
  bucketed hash over them: ``bucket = (key4 * ENTRY_MUL mod 2^32) >>
  (32 - entry_lgb)`` on the BIG-endian first four bytes; a bucket row holds
  ``entry_width`` triples ``(key4, 1 << 28 | idx, pid)``.
* Step at depth d (4, 8, ...): ``rows[state]`` holds up to ``W_ENTRIES``
  triples ``(key, klen << 28 | next, pid)``: finals of length d+1..d+4 keyed
  on their 1-4 bytes past d (big-endian), and the transition to depth d+4.
  A hot state chains into continuation rows (``klen == 0``, ``next`` = the
  row); ``chain`` is the longest chain of the step. Empty triples carry
  ``klen = _KLEN_EMPTY``.

The reference's keys-only filter rows (``fkeys``) serve only its big tier
with no alive filter, which its defaults switch off; they are not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import Automaton
from .probe import Packed

ENTRY_MUL = 0x9E3779B1          # bucket hash multiplier
W_ENTRIES = 8                   # triples per step row before chaining
_NEXT_MASK = 0x0FFFFFFF
_KLEN_EMPTY = 0xF
DESC_WORDS = 4                  # words per descriptor row on the device


@dataclasses.dataclass
class CsrStep:
    depth: int                  # parent depth d; covers finals d+1..d+4
    rows: np.ndarray            # int32 (num_rows, 3*W): (key, meta, pid)
    chain: int                  # longest continuation chain


@dataclasses.dataclass
class CsrTables:
    entry_rows: np.ndarray      # int32 (B, 3*E): (key4, 1<<28|idx, pid)
    entry_lgb: int
    entry_width: int            # E
    steps: list[CsrStep]
    max_len: int
    table_bytes: int            # entry rows + step rows (no fkeys)

    def to_device(self, device) -> Packed:
        """One int32 arena: the entry rows at offset 0, then each step's
        rows. Descriptor rows of ``DESC_WORDS`` words: row 0 is
        ``[0, entry_lgb, width, 0]``; row 1 + s is ``[word offset, row
        count, depth, chain]`` of step s. The entry rows are padded with
        empty triples (meta 0, never a hit) to a width that is a multiple
        of 4, and every offset is a multiple of 4 words, so every row loads
        as whole 16-byte vectors (a 24-word step row as six)."""
        width = -(-self.entry_width // 4) * 4
        entry = np.zeros((self.entry_rows.shape[0], 3 * width), np.int32)
        entry[:, :self.entry_rows.shape[1]] = self.entry_rows
        parts = [entry.reshape(-1)]
        off = parts[0].size
        rows = [(0, self.entry_lgb, width, 0)]
        for s in self.steps:
            assert off % 4 == 0
            rows.append((off, s.rows.shape[0], s.depth, s.chain))
            parts.append(s.rows.reshape(-1))
            off += s.rows.size
        arena = np.concatenate(parts).astype(np.int32, copy=False)
        desc = np.array(rows, dtype=np.int32).reshape(-1, DESC_WORDS)
        return Packed(arena=torch.from_numpy(arena).to(device),
                      desc=torch.from_numpy(desc).to(device), rows=rows)


def _i32(keys: list[int]) -> np.ndarray:
    """uint32 keys -> the int64 values of their int32 views."""
    return np.array(keys, dtype=np.uint32).view(np.int32).astype(np.int64)


def build_csr_tables(automaton: Automaton) -> CsrTables | None:
    """Per-depth CSR tables; None when no pattern has >= 4 bytes."""
    a = automaton
    pats = [bytes(p) for p in a.sorted_patterns]
    pids = [int(x) for x in a.pattern_ids]
    max_len = max((len(p) for p in pats), default=0)
    if max_len < 4:
        return None
    final_of: dict[bytes, int] = {}
    for p, pid in zip(pats, pids):
        final_of[p] = pid            # duplicate pattern: later sorted ID wins

    long_pats = list({p for p in pats if len(p) >= 4})
    by_len: dict[int, list[bytes]] = {}
    for p in long_pats:
        by_len.setdefault(len(p), []).append(p)
    for v in by_len.values():
        v.sort()

    # compact indices at depths 4, 8, 12, ... (1-based; row 0 = empty)
    idx_at: dict[int, dict[bytes, int]] = {}
    live, d = long_pats, 4
    while True:
        live = [p for p in live if len(p) >= d]
        if not live:
            break
        idx_at[d] = {q: i + 1 for i, q in enumerate(sorted({p[:d]
                                                            for p in live}))}
        d += 4

    # ---- entry: bucketed hash over depth-4 prefixes
    e4 = idx_at[4]
    lgb = max(3, int(np.ceil(np.log2(len(e4) * 2))))
    buckets: list[list[tuple[int, int, int]]] = [[] for _ in range(1 << lgb)]
    for q, idx in e4.items():
        key4 = int.from_bytes(q, "big")
        bk = ((key4 * ENTRY_MUL) & 0xFFFFFFFF) >> (32 - lgb)
        buckets[bk].append((key4, (1 << 28) | idx, final_of.get(q, 0)))
    e_width = max(1, max(len(x) for x in buckets))
    entry = np.zeros((1 << lgb, 3 * e_width), np.int64)
    at = [(bk, 3 * j) for bk, items in enumerate(buckets)
          for j in range(len(items))]
    if at:
        r, col = np.array(at, np.int64).T
        flat = [e for items in buckets for e in items]
        entry[r, col] = _i32([e[0] for e in flat])
        entry[r, col + 1] = [e[1] for e in flat]
        entry[r, col + 2] = [e[2] for e in flat]

    steps: list[CsrStep] = []
    d = 4
    while d in idx_at:
        parents = idx_at[d]
        nxt = idx_at.get(d + 4, {})
        per: dict[int, list[list[int]]] = {}
        fin4: dict[tuple[int, int], list[int]] = {}
        for k in range(1, 5):          # finals at depths d+1..d+4
            for q in by_len.get(d + k, ()):
                s = parents[q[:d]]
                e = [int.from_bytes(q[d:], "big"), k << 28, final_of[q]]
                per.setdefault(s, []).append(e)
                if k == 4:
                    fin4[(s, e[0])] = e
        for q, nidx in nxt.items():    # transitions, merged into a k=4 final
            s = parents[q[:d]]
            key = int.from_bytes(q[d:d + 4], "big")
            e = fin4.get((s, key))
            if e is not None:
                e[1] = (4 << 28) | nidx
            else:
                per.setdefault(s, []).append([key, (4 << 28) | nidx, 0])

        # rows, with continuation chaining for hot states
        num_parents = len(parents)
        at_row, at_slot, ks, ms, ps = [], [], [], [], []
        extra = chain_max = 0
        for s in sorted(per):
            entries, row, chain = per[s], s, 0
            while len(entries) > W_ENTRIES:
                head, entries = entries[:W_ENTRIES - 1], entries[W_ENTRIES - 1:]
                cont = num_parents + 1 + extra
                extra += 1
                for j, (k, m, pid) in enumerate(head + [[0, cont, 0]]):
                    at_row.append(row); at_slot.append(j)
                    ks.append(k); ms.append(m); ps.append(pid)
                row = cont
                chain += 1
            for j, (k, m, pid) in enumerate(entries):
                at_row.append(row); at_slot.append(j)
                ks.append(k); ms.append(m); ps.append(pid)
            chain_max = max(chain_max, chain)
        rows = np.zeros((num_parents + 1 + extra, 3 * W_ENTRIES), np.int64)
        rows[:, 1::3] = _KLEN_EMPTY << 28
        if at_row:
            col = 3 * np.array(at_slot, np.int64)
            r = np.array(at_row, np.int64)
            rows[r, col] = _i32(ks)
            rows[r, col + 1] = ms
            rows[r, col + 2] = ps
        steps.append(CsrStep(depth=d, rows=rows.astype(np.int32),
                             chain=chain_max))
        d += 4

    entry_rows = entry.astype(np.int32)
    nbytes = 4 * (entry_rows.size + sum(s.rows.size for s in steps))
    return CsrTables(entry_rows=entry_rows, entry_lgb=lgb,
                     entry_width=e_width, steps=steps, max_len=max_len,
                     table_bytes=nbytes)


"""Host tables of the survivor walk (kernel K2).

Counterpart of ``pfac_tpu.backends.pallas_walk.WProbe.build``,
``build_walk_tables`` and ``walk_oracle``, and of
``pallas_sieve.build_walk_tables_gated`` with its ``_WALK_VMEM_BUDGET``. The
reference functions are numpy, but their module imports JAX, so they are
ported here rather than imported.

Every trie state at an even depth d >= 4 gets a compact per-depth index
(< 2^16). The walk starts with a BIG-endian entry probe on the first four
bytes ``b0<<24 | b1<<16 | b2<<8 | b3`` (-> depth-4 index), then consumes two
bytes per step: from depth d, ``main`` maps ``state<<16 | b1<<8 | b2`` to the
depth-(d+2) index, ``odd`` maps ``state<<8 | b1`` to the ID of a pattern of
length d+1, and ``even`` maps the main key to the ID of a pattern of length
d+2. Every probe is exact (full key compare); values are 16-bit.

On a device the tables have one layout (:func:`pack_walk`), which K2, K3
and the plain walkers read: keys and displacements in 32-bit words, values
in 16-bit half-words. K3 and the plain walkers find a table by its
descriptor row; K2 by the record of its loop's iteration
(:func:`walk_records`), derived from the same rows.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import Automaton, chd
from .probe import FlatProbe, Packed, desc_array
from .sieve_tables import SieveTables, from_chd, ref_bytes

DEAD = 0xFFFF              # never a valid per-depth index
_WALK_VMEM_BUDGET = 6 << 20    # reference tier gate (pallas_sieve.py)
_ALIGN_HALVES = 8          # each array of the layout starts on 16 bytes
RECORD_WORDS = 12          # a K2 record: three probes of four words
DISP_BIT = 1 << 16         # a probe's meta word: lg_b | lg_r << 8 | flags
PRESENT_BIT = 1 << 24


def wprobe(keys, vals) -> FlatProbe:
    """Exact probe over (key, 16-bit value) pairs, as WProbe.build builds it:
    keys sorted first (an empty slot's key is keys[0], so the table bytes
    must not depend on the caller's iteration order)."""
    keys = np.asarray(keys, dtype=np.uint32)
    vals = np.asarray(vals, dtype=np.uint32)
    assert keys.size > 0 and vals.max() < (1 << 16)
    order = np.argsort(keys)
    keys, vals = keys[order], vals[order]
    built = (chd.build_exact_wide2_nodisp(keys, vals)
             if keys.size <= 64 else None)
    t, kw = built if built is not None else chd.build_exact_wide2(keys, vals)
    w = np.asarray(t.slot_words, np.int64) & 0xFFFF
    return from_chd(t, key_words=kw, vals=w.astype(np.int32))


def _wbytes(p: FlatProbe | None) -> int:
    if p is None:
        return 0
    r = 1 << p.lg_r
    return ref_bytes(p, r, -(-r // 2))     # keys + u16-packed values


@dataclasses.dataclass
class Step:
    """One 2-byte walk step, depth d -> d+2."""
    depth: int
    main: FlatProbe | None
    odd: FlatProbe | None
    even: FlatProbe | None


@dataclasses.dataclass
class WalkTables:
    entry: FlatProbe               # 4-byte BE window -> depth-4 index
    entry_final: FlatProbe | None  # 4-byte BE window -> length-4 pattern ID
    steps: list[Step]
    max_len: int
    vmem_bytes: int                # size in the reference's plane layout

    def to_device(self, device) -> Packed:
        """Descriptor rows: entry, entry_final, then main/odd/even for each
        step (step s covers depth 4 + 2s); laid out by :func:`pack_walk`."""
        probes = [self.entry, self.entry_final]
        for s in self.steps:
            probes += [s.main, s.odd, s.even]
        return pack_walk(probes, device)


def pack_walk(probes: list[FlatProbe | None], device) -> Packed:
    """The walk tables as the walk kernels (K2, K3) and the plain walkers
    read them: one descriptor row per entry of `probes` (absent ones
    zeroed); each present table's displacements and keys as 32-bit words
    and its values as 16-bit half-words, in row order, every array padded
    to 16 bytes (so a bulk copy takes any prefix of whole tables). A row
    gives the displacements' and keys' offsets in words and the values' in
    half-words (``arena``, int32 words; half-word h is the low half of
    word h // 2 where h is even, as the card reads it);
    ``derived["table_ends"]`` holds the word at which each table ends.
    Raises ValueError on a value outside 16 bits, which the encoding
    forbids (:data:`DEAD`), and where K2's records cannot hold a table
    (:func:`walk_records`)."""
    parts: list[np.ndarray] = []
    off = 0                                   # half-words

    def put(halves: np.ndarray) -> int:
        nonlocal off
        pad = -halves.size % _ALIGN_HALVES
        parts.extend((halves, np.zeros(pad, np.uint16)))
        start, off = off, off + halves.size + pad
        return start

    def put_words(a: np.ndarray) -> int:
        return put(np.ascontiguousarray(a, np.int32).view(np.uint16)) // 2

    rows, ends = [], []
    for p in probes:
        if p is None:
            rows.append((0, 0, 0, -1, -1, -1, 0, 0))
            continue
        vals = np.asarray(p.vals, np.int64)
        if vals.min() < 0 or vals.max() >= 1 << 16:
            bad = int(vals.min() if vals.min() < 0 else vals.max())
            raise ValueError(f"a walk-table value of {bad} does not fit "
                             "the walk tables' 16-bit values")
        if p.disp is not None and int(np.max(p.disp)) >> p.lg_r:
            raise ValueError(f"a displacement of {int(np.max(p.disp))} is "
                             f"past its table's {1 << p.lg_r} slots: K2's "
                             "record needs every one below them")
        disp = -1 if p.disp is None else put_words(p.disp)
        keys = put_words(p.keys)
        rows.append((p.mul, p.lg_b, p.lg_r, disp, keys,
                     put(vals.astype(np.uint16)), 1, 0))
        ends.append(off // 2)
    words = np.concatenate(parts).view(np.int32)
    return Packed(arena=torch.from_numpy(words).to(device),
                  desc=torch.from_numpy(desc_array(rows)).to(device),
                  rows=rows, derived={"table_ends": ends},
                  records=torch.from_numpy(walk_records(rows)).to(device))


def walk_records(rows: list[tuple[int, ...]]) -> np.ndarray:
    """K2's records, int32[nsteps + 1, RECORD_WORDS], from :func:`pack_walk`'s
    rows (entry, entry_final, then main, odd, even a step): record 0 is the
    entry's iteration (main = row 0, odd absent, even = row 1), record t >= 1
    step t - 1's (rows 3t - 1, 3t, 3t + 1), so a lane at iteration t reads
    its three probes as three 16-byte words at 48 t bytes. A probe is
    ``[mul, key_off, val_off, meta]``, ``meta = lg_b | lg_r << 8`` with
    :data:`DISP_BIT` where the table has displacements and
    :data:`PRESENT_BIT`; an absent probe is four zeros (the card reads slot
    0 of word 0 for it and ignores what it reads). The displacements'
    offset is not stored: the layout puts them just before the keys, padded
    to 16 bytes, at ``key_off - max(2^lg_b, 4)``. The card takes a
    displacement below 2^lg_r, which :func:`pack_walk` checks. Raises
    ValueError on a table whose fields do not fit the record: lg_b or lg_r
    outside 0..31."""
    def probe(row) -> list[int]:
        if row is None or not row[6]:
            return [0, 0, 0, 0]
        mul, lg_b, lg_r, disp_off, key_off, val_off = row[:6]
        if not (0 <= lg_b < 32 and 0 <= lg_r < 32):
            raise ValueError(f"a walk table with lg_b {lg_b} and lg_r {lg_r} "
                             "does not fit K2's record (both below 32)")
        meta = lg_b | lg_r << 8 | PRESENT_BIT
        if disp_off >= 0:
            assert disp_off == key_off - max(1 << lg_b, 4), row
            meta |= DISP_BIT
        return [mul, key_off, val_off, meta]

    triples = [(rows[0], None, rows[1])] + [
        rows[r:r + 3] for r in range(2, len(rows), 3)]
    words = [sum((probe(r) for r in t), []) for t in triples]
    return (np.array(words, np.int64).astype(np.uint32).view(np.int32)
            .reshape(-1, RECORD_WORDS))


def build_walk_tables(automaton: Automaton) -> WalkTables | None:
    """Depth-sliced edge tables; None when the encoding cannot hold the
    ruleset (IDs or per-depth state counts >= 2^16, or no pattern >= 4)."""
    a = automaton
    if a.num_final_states >= DEAD:
        return None
    pats = [bytes(p) for p in a.sorted_patterns]
    pids = [int(x) for x in a.pattern_ids]
    max_len = max((len(p) for p in pats), default=0)
    if max_len < 4:
        return None

    final_of: dict[bytes, int] = {}
    for p, pid in zip(pats, pids):
        final_of[p] = pid          # duplicate pattern: later sorted ID wins

    idx_at: dict[int, dict[bytes, int]] = {}
    for d in range(4, max_len + 1, 2):
        ps = sorted({p[:d] for p in pats if len(p) >= d})
        if len(ps) >= DEAD:
            return None
        idx_at[d] = {q: i for i, q in enumerate(ps)}

    def be32(q: bytes) -> int:
        return int.from_bytes(q, "big")

    e4 = idx_at[4]
    entry = wprobe([be32(q) for q in e4], list(e4.values()))
    f4 = {q: final_of[q] for q in e4 if q in final_of}
    entry_final = (wprobe([be32(q) for q in f4], list(f4.values()))
                   if f4 else None)

    steps: list[Step] = []
    for d in range(4, max_len, 2):
        parents = idx_at[d]
        nxt = idx_at.get(d + 2, {})
        main = None
        if nxt:
            main = wprobe([(parents[q[:d]] << 16) | (q[d] << 8) | q[d + 1]
                           for q in nxt], list(nxt.values()))
        oddf = {q: final_of[q] for q in
                {p[:d + 1] for p in pats if len(p) == d + 1}}
        odd = (wprobe([(parents[q[:d]] << 8) | q[d] for q in oddf],
                      list(oddf.values())) if oddf else None)
        evenf = {q: final_of[q] for q in nxt if q in final_of}
        even = (wprobe([(parents[q[:d]] << 16) | (q[d] << 8) | q[d + 1]
                        for q in evenf], list(evenf.values()))
                if evenf else None)
        steps.append(Step(depth=d, main=main, odd=odd, even=even))

    vmem = _wbytes(entry) + _wbytes(entry_final) + sum(
        _wbytes(s.main) + _wbytes(s.odd) + _wbytes(s.even) for s in steps)
    return WalkTables(entry=entry, entry_final=entry_final, steps=steps,
                      max_len=max_len, vmem_bytes=vmem)


def build_walk_tables_gated(automaton: Automaton,
                            tables: SieveTables) -> WalkTables | None:
    """Walk tables when the ruleset supports them and they fit the
    reference's budget; None sends the ruleset to the CSR tier."""
    if tables.alive is None:
        return None                     # no pattern >= 4 bytes: no walk
    wt = build_walk_tables(automaton)
    if wt is not None and wt.vmem_bytes > _WALK_VMEM_BUDGET:
        return None
    return wt


def walk_oracle(tables: WalkTables, data: bytes, pos: int, n: int) -> int:
    """Host mirror of the walk for one position: the longest match of >= 4
    bytes starting at pos (masked by n), else 0."""
    maxd = n - pos
    window = data[pos: pos + tables.max_len + 2]
    if maxd < 4 or len(window) < 4:
        return 0
    key4 = int.from_bytes(window[:4], "big")
    hit, idx = tables.entry.lookup(key4)
    match = 0
    if tables.entry_final is not None:
        fhit, pid = tables.entry_final.lookup(key4)
        if fhit:
            match = pid
    state = idx if hit else DEAD
    for s in tables.steps:
        d = s.depth
        b1 = window[d] if d < len(window) else 0
        b2 = window[d + 1] if d + 1 < len(window) else 0
        if s.odd is not None and maxd > d:
            ohit, pid = s.odd.lookup((state << 8) | b1)
            if ohit:
                match = pid
        if s.main is None:
            break
        mhit, nxt = s.main.lookup((state << 16) | (b1 << 8) | b2)
        mhit = mhit and maxd > d + 1
        if s.even is not None and mhit:
            ehit, pid = s.even.lookup((state << 16) | (b1 << 8) | b2)
            if ehit:
                match = pid
        state = nxt if mhit else DEAD
    return match

"""Carry the reference package's tables across to the port's flat layout.

``from_jax_tables(sieve_tables, walk_tables)`` takes
``pfac_tpu.backends.pallas_sieve.SieveTables`` and
``pfac_tpu.backends.pallas_walk.WalkTables`` objects and returns the port's
``SieveTables`` / ``WalkTables``; ``from_jax_csr_tables`` takes a
``pfac_tpu.backends.xla_csr.CsrTables`` and returns the port's
``CsrTables``. The objects are read as plain attributes and numpy arrays,
so this module imports no JAX. The tests use it to show that both packages
hold the same tables and so compute the same thing.

Each reference table is a stack of (8, 128) planes whose 8 sublanes are
replicas; ``planes[::8].reshape(-1)[:size]`` recovers the flat words. Packed
forms are then unpacked: u8/u16 displacements, u16 walk values and resid16
residuals to one value per entry, and the exact16 m2 word
``key16 << 16 | id15`` to separate key and value arrays.
"""
from __future__ import annotations

import numpy as np

from .csr_tables import CsrStep, CsrTables
from .probe import FlatProbe
from .sieve_tables import SieveTables, unpack_u16
from .walk_tables import Step, WalkTables


def flat(planes: np.ndarray, size: int) -> np.ndarray:
    """De-replicate lane-major planes into `size` int32 words."""
    return np.asarray(planes)[::8].reshape(-1)[:size].astype(np.int32)


def unpack_u8(words: np.ndarray, size: int) -> np.ndarray:
    w = np.asarray(words, np.int64) & 0xFFFFFFFF
    out = np.stack([(w >> s) & 0xFF for s in (0, 8, 16, 24)], axis=1)
    return out.reshape(-1)[:size].astype(np.int32)


def _disp(p) -> np.ndarray | None:
    if p.nodisp:
        return None
    nb = 1 << p.lg_b
    if p.disp_u8:
        return unpack_u8(flat(p.disp, -(-nb // 4)), nb)
    return unpack_u16(flat(p.disp, -(-nb // 2)), nb)


def _head(p, keys, vals) -> FlatProbe:
    return FlatProbe(mul=int(p.slot_mul) & 0xFFFFFFFF, lg_b=p.lg_b,
                     lg_r=p.lg_r, disp=_disp(p), keys=keys, vals=vals)


def _sieve_probe(p, kind: str) -> FlatProbe | None:
    if p is None:
        return None
    r = 1 << p.lg_r
    if kind == "alive":
        if p.bucket2 or p.resid_bits != 16:
            raise ValueError("the port carries only the resid16 alive filter")
        return _head(p, None, unpack_u16(flat(p.words, r // 2), r))
    words = flat(p.words, r)
    if p.keyw is None:                  # exact16: key16 << 16 | id15
        w = words.astype(np.int64) & 0xFFFFFFFF
        return _head(p, (w >> 16).astype(np.int32),
                     (w & 0x7FFF).astype(np.int32))
    return _head(p, flat(p.keyw, r), words)


def _walk_probe(p) -> FlatProbe | None:
    if p is None:
        return None
    r = 1 << p.lg_r
    return _head(p, flat(p.keyw, r), unpack_u16(flat(p.valw, -(-r // 2)), r))


def _m1(t) -> np.ndarray:
    m1 = np.zeros(256, np.int32)
    if t.m1_chain is not None:
        for ch, pid in t.m1_chain:
            m1[ch] = pid
    elif t.m1 is not None:
        m1 = (unpack_u16(flat(t.m1, 128), 256) if t.m1_packed
              else flat(t.m1, 256))
    return m1


def from_jax_tables(sieve_tables, walk_tables=None):
    """-> (SieveTables, WalkTables | None) in the port's flat layout."""
    if getattr(sieve_tables, "alive_ovf", None) is not None:
        raise ValueError("the port carries only the resid16 alive filter")
    st = SieveTables(
        m1=_m1(sieve_tables),
        m2=_sieve_probe(sieve_tables.m2, "m2"),
        m3=_sieve_probe(sieve_tables.m3, "m3"),
        alive=_sieve_probe(sieve_tables.alive, "alive"),
        vmem_bytes=int(sieve_tables.vmem_bytes),
    )
    if walk_tables is None:
        return st, None
    wt = WalkTables(
        entry=_walk_probe(walk_tables.entry),
        entry_final=_walk_probe(walk_tables.entry_final),
        steps=[Step(depth=s.depth, main=_walk_probe(s.main),
                    odd=_walk_probe(s.odd), even=_walk_probe(s.even))
               for s in walk_tables.steps],
        max_len=int(walk_tables.max_len),
        vmem_bytes=int(walk_tables.vmem_bytes),
    )
    return st, wt


def from_jax_csr_tables(t) -> CsrTables:
    """-> the port's CsrTables. The CSR rows are flat int32 in both
    packages; only the keys-only filter rows (``fkeys``) stay behind."""
    entry = np.asarray(t.entry_rows, np.int32)
    steps = [CsrStep(depth=int(s.depth), rows=np.asarray(s.rows, np.int32),
                     chain=int(s.chain)) for s in t.steps]
    return CsrTables(
        entry_rows=entry, entry_lgb=int(t.entry_lgb),
        entry_width=int(t.entry_width), steps=steps, max_len=int(t.max_len),
        table_bytes=4 * (entry.size + sum(s.rows.size for s in steps)))

"""Host tables of the sieve stage (kernel K1).

Counterpart of ``pfac_tpu.backends.pallas_sieve.SieveTables.build`` and
``_Probe.from_chd``. The same ``chd`` builders run on the same key sets, so
multipliers, ``lg_b``, ``lg_r``, displacements and slot words come out
identical to the reference package's; only the layout differs. The port
keeps every table flat (see ``probe.py``) instead of packing it into
lane-replicated planes, and decodes the packed forms once on the host:

* m1: a 256-entry table of length-1 pattern IDs (the reference's
  compare chain of <= 2 entries lands in the same table);
* m2 (exact16 word ``key16 << 16 | id15``): split into key and value arrays,
  the same form as the wide tables;
* alive (resid16, two residuals per word): one residual per slot on the
  host; ``to_device`` packs them two per word again, as the reference
  does, and lays them last in the arena, where K1 may split them across a
  2-CTA cluster (``csrc/sieve.cu``).

Keys compose little-endian, ``k4 = c3<<24 | c2<<16 | c1<<8 | c0``: m2 probes
``k4 & 0xFFFF``, m3 ``k4 & 0xFFFFFF`` and the alive filter all of ``k4``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import Automaton, chd
from ..status import PfacError, PfacStatus
from .probe import FlatProbe, Packed, pack

LANES = 128                # the reference's plane width (for its size gate)
_M1_CHAIN_MAX = 2          # reference: <= 2 length-1 patterns use no table
_VMEM_TABLE_BUDGET = 8 << 20   # reference tier gate (backends/pallas.py)


def plane_bytes(words: int) -> int:
    """Bytes of `words` int32 words in the reference's (P*8, 128) layout;
    the tier gates compare these sizes so both packages pick one tier."""
    return max(1, -(-words // LANES)) * 8 * LANES * 4


def disp_words(p: FlatProbe) -> int:
    """Packed displacement words of the reference layout (u8 when every
    displacement fits a byte and packing shrinks the plane count)."""
    if p.nodisp:
        return 0
    nb = 1 << p.lg_b
    u8 = int(p.disp.max()) < 256 and nb // 2 > LANES
    return -(-nb // (4 if u8 else 2))


def ref_bytes(p: FlatProbe, *word_counts: int) -> int:
    """Reference-layout bytes of a probe: its packed displacements plus one
    plane stack per slot array of the given word count."""
    out = sum(plane_bytes(w) for w in word_counts)
    return out if p.nodisp else out + plane_bytes(disp_words(p))


def from_chd(t: chd.ChdTable, key_words: np.ndarray | None = None,
             vals: np.ndarray | None = None) -> FlatProbe:
    """A built CHD table -> FlatProbe. `vals` overrides the slot words
    (decoded forms); `key_words` is the int32 key view of wide tables."""
    nodisp = getattr(t, "nodisp_mul", None) is not None
    return FlatProbe(
        mul=int(t.nodisp_mul) if nodisp else chd.slot_multiplier(t.salt),
        lg_b=0 if nodisp else int(np.log2(t.num_buckets)),
        lg_r=t.lg_slots,
        disp=None if nodisp else np.asarray(t.disp, np.int32),
        keys=None if key_words is None else np.asarray(key_words, np.int32),
        vals=np.asarray(t.slot_words if vals is None else vals, np.int32),
    )


def unpack_u16(words: np.ndarray, size: int) -> np.ndarray:
    w = np.asarray(words, np.int64) & 0xFFFFFFFF
    out = np.stack([w & 0xFFFF, w >> 16], axis=1).reshape(-1)
    return out[:size].astype(np.int32)


def pack_u16(vals: np.ndarray) -> np.ndarray:
    """16-bit values -> int32 words, two per word, little half first."""
    v = np.asarray(vals, np.int64) & 0xFFFF
    if v.size % 2:
        v = np.append(v, 0)
    w = v[0::2] | (v[1::2] << 16)
    return w.astype(np.uint32).view(np.int32)


@dataclasses.dataclass
class SieveTables:
    m1: np.ndarray              # int32[256]: length-1 pattern ID per byte
    m2: FlatProbe | None        # exact on k4 & 0xFFFF
    m3: FlatProbe | None        # exact on k4 & 0xFFFFFF
    alive: FlatProbe | None     # resid16 filter on k4 (patterns >= 4 bytes)
    vmem_bytes: int             # size in the reference's plane layout

    @classmethod
    def build(cls, automaton: Automaton) -> "SieveTables":
        if automaton.num_final_states >= (1 << 30):
            raise PfacError(
                PfacStatus.INVALID_PARAMETER,
                "the sieve supports < 2^30 patterns",
            )
        wide_ids = automaton.num_final_states > 0x7FFF
        len1, len2, len3 = {}, {}, {}
        alive_keys = set()
        for idx, pat in enumerate(automaton.sorted_patterns):
            pid = int(automaton.pattern_ids[idx])
            if len(pat) == 1:
                len1[pat[0]] = pid                   # later duplicate wins
            elif len(pat) == 2:
                len2[(pat[1] << 8) | pat[0]] = pid
            elif len(pat) == 3:
                len3[(pat[2] << 16) | (pat[1] << 8) | pat[0]] = pid
            else:
                alive_keys.add(
                    (pat[3] << 24) | (pat[2] << 16) | (pat[1] << 8) | pat[0])

        m1 = np.zeros(256, np.int32)
        for ch, pid in len1.items():
            m1[ch] = pid
        vmem = 0
        if len(len1) > _M1_CHAIN_MAX:
            vmem += plane_bytes(256 if wide_ids else 128)

        m2 = None
        if len2:
            ks = np.array(sorted(len2), dtype=np.uint32)
            vs = np.array([len2[int(k)] for k in ks], dtype=np.uint32)
            if wide_ids:
                m2 = _wide(ks, vs)
                vmem += ref_bytes(m2, 1 << m2.lg_r, 1 << m2.lg_r)
            else:
                t = chd.build_exact2_nodisp(ks, vs) if len(ks) <= 64 else None
                if t is None:
                    t = chd.build_exact2(ks, vs)
                w = np.asarray(t.slot_words, np.int64) & 0xFFFFFFFF
                m2 = from_chd(t, key_words=(w >> 16).astype(np.int32),
                              vals=(w & 0x7FFF).astype(np.int32))
                vmem += ref_bytes(m2, 1 << m2.lg_r)

        m3 = None
        if len3:
            ks = np.array(sorted(len3), dtype=np.uint32)
            vs = np.array([len3[int(k)] for k in ks], dtype=np.uint32)
            m3 = _wide(ks, vs)
            vmem += ref_bytes(m3, 1 << m3.lg_r, 1 << m3.lg_r)

        alive = None
        if alive_keys:
            # The reference's switched-off alive arms are not ported: the
            # bucket-fingerprint filter (ALIVE_BUCKET2_MAX = 0), 8-bit
            # residuals (_RESID8_THRESHOLD = 2^30) and the big-tier skip
            # (_ALIVE_CHD_MAX = 2^30). With < 2^30 patterns none is taken.
            assert len(alive_keys) < (1 << 30)
            ks = np.array(sorted(alive_keys), dtype=np.int64).astype(np.uint32)
            t = chd.build_resid2(ks, bits=16)
            alive = from_chd(t, vals=unpack_u16(t.slot_words, t.num_slots))
            vmem += ref_bytes(alive, t.num_slots // 2)
        return cls(m1=m1, m2=m2, m3=m3, alive=alive, vmem_bytes=vmem)

    def to_device(self, device) -> Packed:
        """Arena: m1 at offset 0, then m2, m3, alive (descriptor rows 0-2);
        the alive residuals packed two per word (slot s in the low half of
        word s // 2 when s is even, else the high half), the last array."""
        alive = self.alive
        if alive is not None:
            alive = dataclasses.replace(alive, vals=pack_u16(alive.vals))
        tabs = pack([self.m2, self.m3, alive], device, head=self.m1)
        assert alive is None or (tabs.rows[2][5] + alive.vals.size
                                 == tabs.arena.numel())
        return tabs


def _wide(ks: np.ndarray, vs: np.ndarray) -> FlatProbe:
    built = chd.build_exact_wide2_nodisp(ks, vs) if len(ks) <= 64 else None
    t, kw = built if built is not None else chd.build_exact_wide2(ks, vs)
    return from_chd(t, key_words=kw)

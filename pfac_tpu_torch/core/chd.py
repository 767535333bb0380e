"""CHD (compress-hash-displace) perfect-hash tables for the probe kernels.

A copy of ``pfac_tpu.core.chd``: both packages build bit-identical tables
from the same keys (``tests/test_torch_core.py``). The notes below describe
the builders as the TPU kernels use them; the port's kernels probe the
same tables as flat arrays (``backends/probe.py``).

The port keeps the builders its tables use: the fused-hash CHD tables
(`build_exact2`/`build_exact_wide2`/`build_resid2`), where bucket and slot
derive from ONE key*mul product and empty exact slots hold a member key so
key equality alone decides a hit, and the displacement-FREE perfect hashes
(`build_*_nodisp`) that a multiplier search finds for small key sets. The
reference's gen-1 split-hash builders, its bucket-fingerprint filter (a
switched-off arm) and its host lookup oracles are not copied: the port's
oracles are ``backends/probe.FlatProbe``'s. All hash arithmetic is in
wrapping 32-bit integers, as the kernels do it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# multiplicative mix constants (odd, high-entropy)
MIX_BUCKET = np.uint32(0x9E3779B1)
MIX_SLOT = np.uint32(0x85EBCA6B)
MIX_RESID = np.uint32(0xC2B2AE35)


def _pow2(x: int) -> int:
    return 1 << max(3, int(np.ceil(np.log2(max(1, x)))))


def slot_multiplier(salt: int) -> int:
    """Salted odd multiplier for the slot hash (salt baked into the kernel)."""
    return ((int(MIX_SLOT) + 2 * salt * 0x27D4EB2F) | 1) & 0xFFFFFFFF


def h_resid(keys: np.ndarray, bits: int = 8) -> np.ndarray:
    return ((keys.astype(np.uint32) * MIX_RESID) >> np.uint32(32 - bits)).astype(np.int64) & ((1 << bits) - 1)


@dataclasses.dataclass
class ChdTable:
    """A built CHD table. slots[] meaning depends on the flavor."""

    disp: np.ndarray        # uint16 [B] displacement per bucket
    slot_words: np.ndarray  # int32 [R_words] packed payload
    num_buckets: int
    num_slots: int
    kind: str               # "exact" | "resid"
    salt: int = 0
    lg_slots: int = 0

    def __post_init__(self):
        self.lg_slots = int(np.log2(self.num_slots))


def _h_fused(keys: np.ndarray, b: int, r: int, salt: int):
    """Fused hashing: bucket, h1 AND the 16-bit residual all come from ONE
    product key*mul — the kernel then needs a single multiply per probe
    (bucket = top lg_b bits, h1 = next lg_r bits, residual = low 16)."""
    lg_b, lg_r = int(np.log2(b)), int(np.log2(r))
    assert lg_b + lg_r <= 32
    prod = keys.astype(np.uint32) * np.uint32(slot_multiplier(salt))
    bucket = (prod >> np.uint32(32 - lg_b)).astype(np.int64) & (b - 1)
    h1 = (prod >> np.uint32(32 - lg_b - lg_r)).astype(np.int64) & (r - 1)
    resid = (prod & np.uint32(0xFFFF)).astype(np.int64)
    return bucket, h1, resid


def _assign_slots(keys: np.ndarray, r: int, b: int,
                  salt: int) -> tuple[np.ndarray, np.ndarray] | None:
    """CHD displacement search. Returns (disp[B], slot_of_key[n]) or None.

    The native C++ implementation (native/pfac_host.cpp::chd_assign) is
    used when available; this Python version is the oracle and fallback.
    Both iterate buckets in stable big-first order so results are
    bit-identical.
    """
    from . import native

    nat = native.chd_assign(keys, r, b, slot_multiplier(salt), fused=True)
    if nat is not NotImplemented:
        return nat  # (disp, slot_of) or None (infeasible)

    n = keys.shape[0]
    buckets, h1, _ = _h_fused(keys, b, r, salt)
    order = np.argsort(-np.bincount(buckets, minlength=b), kind="stable")
    by_bucket: list[list[int]] = [[] for _ in range(b)]
    for i, bk in enumerate(buckets):
        by_bucket[bk].append(i)

    disp = np.zeros(b, dtype=np.uint16)
    occupied = np.zeros(r, dtype=bool)
    slot_of = np.full(n, -1, dtype=np.int64)
    for bk in order:
        members = by_bucket[bk]
        if not members:
            continue
        hs = h1[members]
        if len(set(hs.tolist())) != len(members):
            return None  # intra-bucket h1 collision: caller must grow R
        found = False
        for d in range(min(65536, 4 * r)):
            slots = (hs ^ d) & (r - 1)
            if not occupied[slots].any():
                occupied[slots] = True
                slot_of[members] = slots
                disp[bk] = d
                found = True
                break
        if not found:
            return None
    return disp, slot_of


def _build(keys: np.ndarray,
           r: int | None = None) -> tuple[np.ndarray, np.ndarray, int, int, int]:
    """Search (R, B, salt) combos in ascending kernel-cost order.

    Kernel probe cost is linear in table words scanned, so prefer the
    tightest R (even at ~0.98 load) with the smallest workable B.
    """
    keys = np.asarray(keys, dtype=np.uint32)
    n = keys.shape[0]
    if np.unique(keys).shape[0] != n:
        raise ValueError("CHD keys must be unique")
    r_min = r or _pow2(int(np.ceil(n * 1.02)))
    candidates = []
    for r_try in (r_min, r_min * 2, r_min * 4, r_min * 8):
        for b_try in (_pow2(max(8, n // 8)), _pow2(max(8, n // 4)),
                      _pow2(max(8, n // 2)), _pow2(max(8, n))):
            if int(np.log2(r_try)) + int(np.log2(b_try)) > 32:
                continue
            candidates.append((r_try, b_try))
    # ascending total scanned words (resid packing: R/4 + B/2 as proxy)
    candidates.sort(key=lambda rb: rb[0] + rb[1])
    seen = set()
    for r_try, b_try in candidates:
        if (r_try, b_try) in seen:
            continue
        seen.add((r_try, b_try))
        first = None
        for salt in range(24):
            res = _assign_slots(keys, r_try, b_try, salt)
            if res is not None:
                disp, slot_of = res
                if int(disp.max()) < 256:
                    # byte-sized displacements pack 4/word: one fewer
                    # probe gather in the kernel — worth scanning salts for
                    return disp, slot_of, r_try, b_try, salt
                if first is None:
                    first = (disp, slot_of, r_try, b_try, salt)
        if first is not None:
            return first
    raise RuntimeError("CHD build failed to converge")


# ---------------------------------------------------------------------------
# Fused-hash builders (the sieve kernel's tables): ONE multiply per probe
# derives bucket (top bits), h1 (next bits) and the 16-bit residual (low
# bits). Exact tables use the "member-key fill" trick for empty slots:
# an empty slot's key field holds an arbitrary MEMBER key, which no probe
# can match there (members always probe their own slots), so the kernel
# needs no valid-bit test at all.
# ---------------------------------------------------------------------------

def build_exact2(keys: np.ndarray, values: np.ndarray) -> ChdTable:
    """Fused exact table: word = key16 << 16 | value15; empty slots hold
    (member_key << 16) so key-compare alone decides the hit."""
    keys = np.asarray(keys, dtype=np.uint32)
    values = np.asarray(values, dtype=np.uint32)
    assert keys.size > 0 and keys.max() < (1 << 16) and values.max() < (1 << 15)
    disp, slot_of, r, b, salt = _build(keys)
    words = np.full(r, np.uint32(keys[0]) << np.uint32(16), dtype=np.uint32)
    words[slot_of] = (keys << np.uint32(16)) | values
    return ChdTable(disp=disp, slot_words=words.astype(np.int32),
                    num_buckets=b, num_slots=r, kind="exact2", salt=salt)


def build_exact_wide2(keys: np.ndarray, values: np.ndarray) -> tuple[ChdTable, np.ndarray]:
    """Fused wide exact table: full key word + bare value word."""
    keys = np.asarray(keys, dtype=np.uint32)
    values = np.asarray(values, dtype=np.uint32)
    assert keys.size > 0 and values.max() < (1 << 30)
    disp, slot_of, r, b, salt = _build(keys)
    words = np.zeros(r, dtype=np.uint32)
    words[slot_of] = values
    key_words = np.full(r, keys[0], dtype=np.uint32)
    key_words[slot_of] = keys
    t = ChdTable(disp=disp, slot_words=words.astype(np.int32),
                 num_buckets=b, num_slots=r, kind="exact_wide2", salt=salt)
    return t, key_words.view(np.int32)


def build_resid2(keys: np.ndarray, bits: int = 16) -> ChdTable:
    """Fused-slot residual filter: bucket/h1 come from the fused product,
    but the stored residual is the TOP `bits` bits of an INDEPENDENT
    product key*MIX_RESID (h_resid), packed 32//bits per word.

    The residual must be independent of the slot hash: the original
    fused form stored low product bits, which OVERLAP the h1 bit range
    once lg_b + lg_r approaches 32 — at 100K keys the "2^-16" filter
    actually passed ~1% of random probes (r5 capture,
    experiments/logs_r5/csr_profile.log: 715K survivors where the exact
    count was ~5K). One extra VPU multiply per probe buys the nominal
    FP rate at every table size.

    bits=16 (FP ~2^-16) is the default; bits=8 (FP ~2^-8, half the probe
    planes) pays off only where a false positive is walker-cheap (see
    pallas_sieve._RESID8_THRESHOLD)."""
    assert bits in (8, 16)
    per_word = 32 // bits
    mask = np.uint32((1 << bits) - 1)
    keys = np.asarray(keys, dtype=np.uint32)
    assert keys.size > 0
    disp, slot_of, r, b, salt = _build(keys)
    resid_of = h_resid(keys, bits)
    resid = np.full(r, np.uint32(0x5555) & mask, dtype=np.uint32)
    resid[slot_of] = resid_of.astype(np.uint32) & mask
    words = np.zeros(r // per_word, dtype=np.uint32)
    for j in range(per_word):
        words |= resid[j::per_word] << np.uint32(bits * j)
    return ChdTable(disp=disp, slot_words=words.astype(np.int32),
                    num_buckets=b, num_slots=r, kind=f"resid2_{bits}",
                    salt=salt)


def _search_nodisp_mul(keys: np.ndarray, r: int, tries: int = 1 << 17) -> int | None:
    """Find an odd multiplier making slot = (key*mul) >> (32-lg_r) perfect
    (no displacement array at all — saves the probe's disp gather).
    Practical only for small key sets (collision prob ~ n^2/2r per try)."""
    lg_r = int(np.log2(r))
    n = keys.shape[0]
    if n > r:
        return None
    rng = np.random.default_rng(0xC0FFEE ^ (n * 2654435761) & 0xFFFFFFFF)
    max_chunk = max(1, (1 << 22) // max(1, n))
    # grow the batch geometrically: small key sets usually succeed within
    # the first few dozen tries, so don't pay a multi-million-row batch
    chunk = min(max_chunk, 512)
    done = 0
    while done < tries:
        muls = (rng.integers(0, 1 << 31, size=chunk, dtype=np.int64) * 2 + 1
                ).astype(np.uint32)
        prods = keys[None, :].astype(np.uint32) * muls[:, None]
        slots = (prods >> np.uint32(32 - lg_r)).astype(np.int64)
        slots.sort(axis=1)
        ok = (np.diff(slots, axis=1) != 0).all(axis=1)
        hit = np.nonzero(ok)[0]
        if hit.size:
            return int(muls[hit[0]])
        done += chunk
        chunk = min(max_chunk, chunk * 4)
    return None


def build_exact2_nodisp(keys: np.ndarray, values: np.ndarray) -> ChdTable | None:
    """Displacement-free fused exact table (one gather per probe).
    Returns None when no perfect multiplier is found quickly."""
    keys = np.asarray(keys, dtype=np.uint32)
    values = np.asarray(values, dtype=np.uint32)
    assert keys.size > 0 and keys.max() < (1 << 16) and values.max() < (1 << 15)
    for r in (_pow2(int(keys.size * 1.5)), _pow2(int(keys.size * 1.5)) * 2):
        mul = _search_nodisp_mul(keys, r)
        if mul is None:
            continue
        lg_r = int(np.log2(r))
        slots = (keys * np.uint32(mul)) >> np.uint32(32 - lg_r)
        words = np.full(r, np.uint32(keys[0]) << np.uint32(16), dtype=np.uint32)
        words[slots] = (keys << np.uint32(16)) | values
        t = ChdTable(disp=np.zeros(1, np.uint16), slot_words=words.astype(np.int32),
                     num_buckets=1, num_slots=r, kind="exact2_nodisp")
        t.salt = -1
        t.nodisp_mul = mul
        return t
    return None


def build_exact_wide2_nodisp(keys: np.ndarray, values: np.ndarray):
    """Displacement-free fused wide table. Returns (table, key_words) or None."""
    keys = np.asarray(keys, dtype=np.uint32)
    values = np.asarray(values, dtype=np.uint32)
    assert keys.size > 0 and values.max() < (1 << 30)
    for r in (_pow2(int(keys.size * 1.5)), _pow2(int(keys.size * 1.5)) * 2):
        mul = _search_nodisp_mul(keys, r)
        if mul is None:
            continue
        lg_r = int(np.log2(r))
        slots = (keys * np.uint32(mul)) >> np.uint32(32 - lg_r)
        words = np.zeros(r, dtype=np.uint32)
        words[slots] = values
        key_words = np.full(r, keys[0], dtype=np.uint32)
        key_words[slots] = keys
        t = ChdTable(disp=np.zeros(1, np.uint16), slot_words=words.astype(np.int32),
                     num_buckets=1, num_slots=r, kind="exact_wide2_nodisp")
        t.salt = -1
        t.nodisp_mul = mul
        return t, key_words.view(np.int32)
    return None

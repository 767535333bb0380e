"""Plain K1 (the port's sieve on a CPU tensor) against the reference's
Pallas sieve kernel in interpret mode, bit-exact (tolerance 0).

The reference kernel runs as ``build_pipeline(..., kernel_only=True,
interpret=True)`` with 64-row tiles; its survivor bitmap is decoded as
position ``g*1024 + s*128 + j`` for bit s of lane j in bitmap row g
(pallas_sieve._compact). The port's match tile must equal the kernel's on
[0, n) (zeros past n); the port's bitmap (bit j of word w: position
32w + j), decoded with numpy, must list the reference bitmap's positions,
and so must the plain compaction; its per-block survivor counts must be
the bitmap's counts over the same blocks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pfac_tpu.backends.pallas_sieve as S
from pfac_tpu_torch.backends import compact, sieve
from pfac_tpu_torch.backends.sieve_matcher import npad_for
from pfac_tpu_torch.backends.sieve_tables import SieveTables
from pfac_tpu_torch.core import Automaton

TILE = 64


def _bitmap_positions(bits: np.ndarray) -> np.ndarray:
    rows, lanes = np.nonzero(np.asarray(bits, np.int64) & 0xFF)
    out = []
    for g, j in zip(rows.tolist(), lanes.tolist()):
        w = int(bits[g, j]) & 0xFF
        out += [g * 1024 + s * 128 + j for s in range(8) if (w >> s) & 1]
    return np.array(sorted(out), dtype=np.int64)


def _port_bitmap_positions(bits: np.ndarray) -> np.ndarray:
    flags = np.unpackbits(np.ascontiguousarray(bits).view(np.uint8),
                          bitorder="little")
    return np.nonzero(flags)[0]


def _compare(pats, data: bytes):
    a = Automaton.from_patterns(pats)
    n = len(data)
    jt = S.SieveTables.build(a)
    npad = S.npad_for(n, TILE)
    run = S.build_pipeline(a, jt, npad=npad, cap=1024, interpret=True,
                           kernel_only=True, tile_rows=TILE)
    out, bits = run([jnp.asarray(x) for x in jt.arrays],
                    jnp.zeros(1, jnp.int32),
                    jnp.asarray(np.frombuffer(data, np.uint8)),
                    jnp.full((1,), n, jnp.int32))
    want = np.asarray(out)[:n]
    want_pos = _bitmap_positions(np.asarray(bits))

    tabs = SieveTables.build(a).to_device("cpu")
    t = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    pnpad = npad_for(n)
    match, bits, counts = sieve.sieve(t, n, pnpad, tabs)
    got = match.numpy()
    assert np.array_equal(got[:n], want)
    assert not got[n:].any()
    assert bits.dtype == torch.int32 and bits.shape[0] == pnpad // 32
    assert np.array_equal(_port_bitmap_positions(bits.numpy()), want_pos)
    # no block is dense at a threshold above the block
    pos = compact.compact_plain(bits, counts, sieve.BLOCK + 1)
    assert np.array_equal(pos.numpy(), want_pos)
    # survivors per 64K block: the bitmap's positions counted by block
    assert np.array_equal(counts.numpy(), np.bincount(
        want_pos // sieve.BLOCK, minlength=pnpad // sieve.BLOCK))
    return want_pos


def test_readme_example():
    _compare([b"AB", b"ABG", b"BEDE", b"ED"], b"ABEDEDABG")


def test_end_of_input_every_depth():
    # matches whose window touches n, and truncated prefixes at n
    pats = [b"q", b"qw", b"qwe", b"qwert", b"\x00", b"\x00\x01"]
    for tail in (b"qwert", b"qwer", b"qwe", b"qw", b"q", b"\x00"):
        _compare(pats, b"xx\x00\x01qwertqwe" + tail)


@pytest.mark.parametrize("n", [8191, 8192, 8193, 8194])
def test_block_straddle_and_lengths(n):
    # lengths around the 8192-position tile and not a multiple of 4;
    # patterns straddling the tile boundary and ending exactly at n
    rng = np.random.default_rng(n)
    pats = [b"HELLO", b"HEL", b"LO", b"O", b"\xff\xfe\x80\x81", b"\x81\xff"]
    data = bytearray(rng.integers(0, 256, size=n, dtype=np.uint8).tobytes())
    for off in (8187, 8188, 8189, 8190, 4096):
        if off + 5 <= n:
            data[off:off + 5] = b"HELLO"
    data[-4:] = b"\xff\xfe\x80\x81"
    pos = _compare(pats, bytes(data))
    assert pos.size > 0


@pytest.mark.parametrize("seed", range(3))
def test_random_rulesets(seed):
    rng = np.random.default_rng(seed)
    alpha = rng.integers(0, 256, size=int(rng.integers(3, 7))).astype(np.uint8)
    pats = [bytes(alpha[rng.integers(0, len(alpha), size=int(rng.integers(1, 9)))])
            for _ in range(int(rng.integers(5, 40)))]
    data = bytes(alpha[rng.integers(0, len(alpha), size=int(rng.integers(500, 9000)))])
    _compare(pats, data)


def test_wide_ids():
    # > 0x7FFF patterns: wide m1/m2 encodings
    rng = np.random.default_rng(9)
    keys = rng.choice(1 << 16, size=33000, replace=False)
    pats = [bytes([k >> 8, k & 0xFF]) for k in keys]
    pats += [b"a", b"b", b"c", b"XYZq", b"XYZ"]
    data = bytes(rng.integers(0, 256, size=3000, dtype=np.uint8)) + b"XYZqabc"
    _compare(pats, data)

"""The dense-block escape on the CPU against the reference's, bit-exact
(tolerance 0). With ``tile=8192`` a block is the reference's interpret-mode
block of 8,192 positions: ``Matcher(device="cpu")`` is held against
``SieveMatcher(interpret=True)`` and the golden model, and each case shows
how many blocks escaped."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pfac_tpu.backends.pallas_sieve as S
import pfac_tpu_torch as pt
from pfac_tpu.backends import golden
from pfac_tpu_torch.backends import block_walk, compact, pipeline, sieve
from pfac_tpu_torch.backends.sieve_matcher import npad_for

BLOCK = 8192


def _escaped(m, data: bytes) -> int:
    eng = m._engine()
    npad = npad_for(len(data), eng.tile_rows)
    t = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    _, _, counts = sieve.sieve(t, len(data), npad, eng._sieve, BLOCK)
    return block_walk.escaped_blocks(counts, npad)


def _check(pats, data: bytes, reference: bool = True):
    m = pt.Matcher(pats, device="cpu", tile=BLOCK)
    assert m._engine().tile_rows * 128 == BLOCK
    got = m.match(data)
    assert got.tolist() == golden.match_edges_batch(m.automaton,
                                                    data).tolist()
    if reference:
        ref = S.SieveMatcher(m.automaton, interpret=True)
        assert ref.tile_rows * S.LANES == BLOCK
        assert got.tolist() == np.asarray(ref.match(data)).tolist()
    # the same result with the escape disarmed: every survivor through K2
    eng = m._engine()
    t = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    off = pipeline.run(t, len(data), npad_for(len(data), eng.tile_rows),
                       eng._sieve, eng._walk, block=BLOCK, escape=False)
    assert off[:len(data)].tolist() == got.tolist()
    return m, got


def test_all_match_single_pattern():
    data = b"a" * (3 * BLOCK + 1111)
    m, got = _check([b"aaaa"], data)
    assert _escaped(m, data) == 3       # the last block's 1,108 do not reach
    assert (got[:-3] == 1).all() and not got[-3:].any()


def _mixed():
    rng = np.random.default_rng(3)
    pats = [bytes(rng.integers(0, 256, size=int(k), dtype=np.uint8))
            for k in list(rng.integers(1, 4, size=10))
            + list(rng.integers(4, 30, size=60))]
    pats = list(dict.fromkeys(pats)) + [b"zzzz", b"zzzzzzzz"]
    n = 3 * BLOCK + 1111
    d = rng.integers(0, 256, size=n, dtype=np.uint8)
    d[BLOCK:2 * BLOCK] = ord("z")       # middle block escapes; others sparse
    for i in range(0, n - 40, 177):
        p = pats[int(rng.integers(0, len(pats)))]
        d[i:i + len(p)] = np.frombuffer(p, np.uint8)
    return pats, d.tobytes()


def test_mixed_density_blocks_and_deep_patterns():
    pats, data = _mixed()
    m, _ = _check(pats, data)
    assert _escaped(m, data) == 1


def test_escape_block_boundary_straddle():
    # a long match starting in an escaped block reads the next block's bytes
    d = np.zeros(2 * BLOCK, np.uint8)
    d[BLOCK - 20:BLOCK + 60] = ord("z")
    d[:BLOCK] = ord("z")                # block 0: every position survives
    m, got = _check([b"z" * 40], d.tobytes())
    assert _escaped(m, d.tobytes()) == 1
    assert got[BLOCK - 1] == 1 and got[BLOCK + 20] == 1


def test_long_patterns_escape():
    # the reference arms its escape only for max_len + 4 <= HALO_ROWS*LANES
    # (its VMEM staging); the port reads the corpus directly, so a dense
    # block with matches of ~1 KB that run into the next block escapes too
    pats = [b"z" * 1000 + b"y", b"zzzz", b"z" * 600 + b"y"]
    d = bytearray(b"z" * (BLOCK + 500) + b"y" + bytes(3000))
    d[5000:5001] = b"y"
    m, got = _check(pats, bytes(d), reference=False)
    eng = m._engine()
    assert eng.walk_tables is not None and eng.walk_tables.max_len == 1001
    assert _escaped(m, bytes(d)) == 1
    assert got[4000] == 1 and got[4400] == 3 and got[4001] == 2
    assert got[BLOCK - 500] == 1 and got[BLOCK - 100] == 3   # across the edge


def test_block_counts_equal_reference_bitmap():
    # K1's per-block survivor counts against the popcount of the
    # reference kernel's survivor bitmap over the same 8,192-position blocks
    pats, data = _mixed()
    a = pt.Automaton.from_patterns(pats)
    n = len(data)
    jt = S.SieveTables.build(a)
    npad = S.npad_for(n, 64)
    run = S.build_pipeline(a, jt, npad=npad, cap=1024, interpret=True,
                           kernel_only=True, tile_rows=64)
    _, bits = run([jnp.asarray(x) for x in jt.arrays], jnp.zeros(1, jnp.int32),
                  jnp.asarray(np.frombuffer(data, np.uint8)),
                  jnp.full((1,), n, jnp.int32))
    bits = np.asarray(bits).astype(np.int64) & 0xFF     # (npad // 1024, 128)
    per_row = np.vectorize(lambda x: bin(x).count("1"))(bits).sum(axis=1)
    want = per_row.reshape(-1, BLOCK // 1024).sum(axis=1)
    m = pt.Matcher(pats, device="cpu", tile=BLOCK)
    t = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    _, bits, counts = sieve.sieve(t, n, npad, m._engine()._sieve, BLOCK)
    assert counts.tolist() == want.tolist()
    assert counts.tolist() == sieve.unpack_bits(bits).view(-1, BLOCK).sum(
        1).tolist()
    assert counts[1] >= BLOCK // block_walk.DENSE_ESCAPE_DIV > counts[0]


def test_block_walk_plain_clears_only_dense_blocks():
    # K3 no longer clears flags: the compaction leaves out exactly the
    # dense blocks, whose positions K3 walked, and lists every survivor of
    # the others
    pats, data = _mixed()
    m = pt.Matcher(pats, device="cpu", tile=BLOCK)
    eng = m._engine()
    n = len(data)
    npad = npad_for(n, eng.tile_rows)
    t = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    match, bits, counts = sieve.sieve(t, n, npad, eng._sieve, BLOCK)
    before = bits.clone()
    block_walk.block_walk(t, n, counts, match, eng._walk)
    assert torch.equal(bits, before)
    thresh = BLOCK // block_walk.DENSE_ESCAPE_DIV
    dense = counts >= thresh
    flags = sieve.unpack_bits(bits).view(-1, BLOCK)
    pos = compact.compact(bits, counts, thresh)
    assert not bool(dense[pos.long() // BLOCK].any())
    want = torch.nonzero(flags[~dense].reshape(-1)).reshape(-1)
    keep = torch.nonzero(~dense).reshape(-1)
    want = keep[want // BLOCK] * BLOCK + want % BLOCK
    assert pos.tolist() == want.tolist() and dense.any()
    with pytest.raises(ValueError):
        block_walk.block_walk(t, n, counts[:3], match, eng._walk)

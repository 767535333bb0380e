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
from pfac_tpu_torch.backends.walk_tables import DEAD, build_walk_tables

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
    pos, _ = compact.compact(bits, counts, thresh)
    assert not bool(dense[pos.long() // BLOCK].any())
    want = torch.nonzero(flags[~dense].reshape(-1)).reshape(-1)
    keep = torch.nonzero(~dense).reshape(-1)
    want = keep[want // BLOCK] * BLOCK + want % BLOCK
    assert pos.tolist() == want.tolist() and dense.any()
    with pytest.raises(ValueError):
        block_walk.block_walk(t, n, counts[:3], match, eng._walk)


def _alive_steps(wt, data: bytes, n: int, p: int) -> list[bool]:
    """Whether position p's walk is alive as each step starts, stepped one
    table at a time on the host tables."""
    out = [False] * len(wt.steps)
    if n - p < 4:
        return out
    hit, state = wt.entry.lookup(int.from_bytes(data[p:p + 4], "big"))
    if not hit:
        return out
    for i, s in enumerate(wt.steps):
        out[i] = True
        if s.main is None:
            break
        d = s.depth
        b = [data[p + d + j] if p + d + j < n else 0 for j in (0, 1)]
        hit, state = s.main.lookup((state << 16) | (b[0] << 8) | b[1])
        if not hit or n - p <= d + 1 or state == DEAD:
            break
    return out


def _k3_probes_by_hand(wt, data: bytes, n: int, tiles: list[int]) -> int:
    """csrc/block_walk.cu's probes, its control flow written out: a batch
    of 8 positions, its entry probes, its steps while two are alive, then
    the last one alive alone."""
    steps = wt.steps
    total = 0
    for c0 in tiles:
        for b0 in range(c0, c0 + block_walk.CHUNK, 8):
            alive = [_alive_steps(wt, data, n, p) for p in range(b0, b0 + 8)]
            total += 8 * ((len(steps) > 0) + (wt.entry_final is not None))
            st, ended = 0, False
            while st < len(steps) and sum(a[st] for a in alive) >= 2:
                s = steps[st]
                total += 8 * (s.odd is not None)
                if s.main is None:
                    ended = True
                    break
                total += 8 * (1 + (s.even is not None))
                st += 1
            lone = [a for a in alive if st < len(steps) and a[st]]
            while not ended and lone and st < len(steps) and lone[0][st]:
                s = steps[st]
                total += sum(t is not None for t in (s.odd, s.main, s.even))
                ended = s.main is None
                st += 1
    return total


@pytest.mark.parametrize("case", ["all_match", "mixed"])
def test_block_walk_probes_plain_recounts_the_kernels_dealing(case):
    # K3's probes as its program counts them (block_walk_probes), recounted
    # vectorised, equal its control flow written out position by position;
    # on all-match (aaaa: no steps) one entry_final probe a position of the
    # three dense blocks, the last block's 1,108 survivors too few
    if case == "all_match":
        pats, data = [b"aaaa"], b"a" * (3 * BLOCK + 1111)
    else:
        pats, data = _mixed()
    m = pt.Matcher(pats, device="cpu", tile=BLOCK)
    eng = m._engine()
    n = len(data)
    npad = npad_for(n, eng.tile_rows)
    t = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    _, _, counts = sieve.sieve(t, n, npad, eng._sieve, BLOCK)
    got = block_walk.block_walk_probes_plain(t, n, counts, eng._walk, BLOCK)
    tiles = block_walk.dense_tiles(n, counts, BLOCK)
    assert got == _k3_probes_by_hand(build_walk_tables(m.automaton), data, n,
                                     tiles)
    walked = len(tiles) * block_walk.CHUNK
    if case == "all_match":
        assert block_walk.steps_of(eng._walk) == 0
        assert len(tiles) == 3 and got == walked == 3 * BLOCK
    else:
        assert len(tiles) == 1 and got > 2 * walked


def test_block_walk_probes_plain_counts_the_lone_walk():
    # a run of z's ends in a batch: its last alive position walks on alone
    # (walk_tail), a probe a present table a step, and the positions past
    # n are probed as the kernel probes them
    pats = [b"zzzz", b"z" * 12, b"z" * 20 + b"y"]
    d = np.zeros(BLOCK + 100, np.uint8)
    d[:BLOCK - 4] = ord("z")         # a batch starts 12 z's before its end
    data = d.tobytes()
    m = pt.Matcher(pats, device="cpu", tile=BLOCK)
    eng = m._engine()
    n = len(data)
    t = torch.from_numpy(d.copy())
    _, _, counts = sieve.sieve(t, n, npad_for(n, eng.tile_rows), eng._sieve,
                               BLOCK)
    tiles = block_walk.dense_tiles(n, counts, BLOCK)
    assert tiles == [0]
    got = block_walk.block_walk_probes_plain(t, n, counts, eng._walk, BLOCK)
    assert got == _k3_probes_by_hand(build_walk_tables(m.automaton), data, n,
                                     tiles)
    # below the batched steps: 8 a table, a batch's 8 positions each time
    assert got % 8 != 0

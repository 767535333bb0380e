"""The port's device reduce (``pfac_tpu_torch.backends.reduce``) against the
reference's ``pallas_sieve.reduce_from_dense`` and
``xla._reduce_rowgather`` on the same seeded dense results, bit-exact
(tolerance 0): ids and positions as long as the result, positions
ascending, zeros past the count, the count a 0-d int32 tensor. On the CPU
the wrapper runs its plain version; the kernels' own pieces (each tile's
count, the offsets the look-back must find, the zeros past the count) are
held here through their plain versions, and on the card by
``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from pfac_tpu.backends import pallas_sieve, xla as ref_xla
from pfac_tpu_torch.backends import reduce, sieve

BLOCK = sieve.BLOCK
TILE = reduce.TILE


def _result(kind: str, npad: int) -> np.ndarray:
    rng = np.random.default_rng(npad)
    if kind == "none":
        return np.zeros(npad, np.int32)
    if kind == "all":
        return rng.integers(1, 40000, size=npad).astype(np.int32)
    share = {"3pct": 0.03, "sparse": 2e-4}[kind]
    out = np.zeros(npad, np.int32)
    hit = rng.random(npad) < share
    out[hit] = rng.integers(1, 40000, size=int(hit.sum()))
    return out


CASES = [("none", 2 * BLOCK), ("all", BLOCK), ("3pct", 3 * BLOCK),
         ("3pct", 2 * BLOCK + 4_000), ("sparse", BLOCK + 77), ("all", 4_160),
         # the kernels' edges: one position, a cut last tile, count 0 and
         # count npad on cut tiles, a single whole tile
         ("all", 1), ("none", 1), ("3pct", 3 * TILE + 5), ("none", TILE + 3),
         ("all", 2 * TILE + 3), ("all", TILE)]


@pytest.mark.parametrize("kind,npad", CASES,
                         ids=[f"{k}-{n}" for k, n in CASES])
def test_reduce_equals_reference(kind, npad):
    res = _result(kind, npad)
    ids, pos, count = reduce.reduce_from_dense(torch.from_numpy(res))
    assert count.dim() == 0 and count.dtype == torch.int32
    assert ids.dtype == pos.dtype == torch.int32
    assert ids.shape[0] == pos.shape[0] == npad
    c = int(count)
    assert c == int((res > 0).sum())
    assert not ids[c:].any() and not pos[c:].any()     # tail zero
    r_ids, r_pos, r_n = pallas_sieve.reduce_from_dense(res)
    assert c == int(r_n)
    assert ids.numpy().tolist() == np.asarray(r_ids).tolist()
    assert pos.numpy().tolist() == np.asarray(r_pos).tolist()
    g_ids, g_pos, g_n = ref_xla._reduce_rowgather(res)
    assert c == int(g_n)
    assert ids[:c].tolist() == np.asarray(g_ids)[:c].tolist()
    assert pos[:c].tolist() == np.asarray(g_pos)[:c].tolist()


@pytest.mark.parametrize("kind,npad", CASES,
                         ids=[f"{k}-{n}" for k, n in CASES])
def test_tile_pieces_equal_reference(kind, npad):
    # the kernels' pieces in their plain versions: each tile's count (its
    # aggregate), the exclusive offsets the look-back must find, the
    # matches at offset + rank in the tile, and the zeros of [count, npad)
    res = _result(kind, npad)
    r_ids, r_pos, r_n = (np.asarray(a) for a in
                         pallas_sieve.reduce_from_dense(res))
    n = int(r_n)
    t = torch.from_numpy(res)
    counts = reduce.tile_counts_plain(t)
    assert counts.shape[0] == reduce.tiles(npad) == -(-npad // TILE)
    want = np.bincount(r_pos[:n] // TILE, minlength=counts.shape[0])
    assert counts.tolist() == want.tolist()
    offsets = reduce.tile_offsets_plain(counts)
    assert offsets.tolist() == (np.cumsum(want) - want).tolist()
    # a tile's offset is where its first match sits in the reference's list
    for tile, off in enumerate(offsets.tolist()):
        if want[tile]:
            assert r_pos[off] // TILE == tile
            assert off == 0 or r_pos[off - 1] // TILE < tile
    ids, pos, count = reduce.reduce_tiles_plain(t)
    assert int(count) == n == int(offsets[-1] + counts[-1])
    assert ids.tolist() == r_ids.tolist() and pos.tolist() == r_pos.tolist()
    assert not ids[n:].any() and not pos[n:].any()
    g_ids, g_pos, _ = ref_xla._reduce_rowgather(res)
    assert ids[:n].tolist() == np.asarray(g_ids)[:n].tolist()
    assert pos[:n].tolist() == np.asarray(g_pos)[:n].tolist()


@pytest.mark.parametrize("npad", [0, 1, TILE, 128 << 20, 100 << 20])
def test_bound_counts_every_output_word(npad):
    # the result read once, both npad-long outputs written in full: 12 B a
    # position whatever the count (0.481 ms at 128 Mi positions, 3.35 TB/s)
    assert reduce.bound_bytes(npad) == 4 * npad + 2 * 4 * npad
    if npad == 128 << 20:
        assert round(reduce.bound_bytes(npad) / 3.35e12 * 1e3, 3) == 0.481


def test_reduce_checks_its_input():
    for bad in (torch.zeros(8, dtype=torch.int64), torch.zeros(2, 4,
                                                               dtype=torch.int32)):
        with pytest.raises(ValueError):
            reduce.reduce_from_dense(bad)
    with pytest.raises(ValueError):
        reduce.reduce_from_dense(torch.zeros(8, dtype=torch.int32)[::2])
    with pytest.raises(ValueError, match="no reduce"):
        reduce.reduce_from_dense(torch.zeros(8, dtype=torch.int32,
                                             device="meta"))
    ids, pos, count = reduce.reduce_from_dense(torch.zeros(0,
                                                           dtype=torch.int32))
    assert ids.numel() == pos.numel() == 0 and int(count) == 0

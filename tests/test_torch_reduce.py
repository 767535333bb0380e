"""The port's device reduce (``pfac_tpu_torch.backends.reduce``) against the
reference's ``pallas_sieve.reduce_from_dense`` and
``xla._reduce_rowgather`` on the same seeded dense results, bit-exact
(tolerance 0): ids and positions as long as the result, positions
ascending, zeros past the count, the count a 0-d int32 tensor. On the CPU
the wrapper runs its plain version; the kernels' own pieces (the bitmap
and block counts, the compaction with its fused gather) are held here
through their plain versions, and on the card by ``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from pfac_tpu.backends import pallas_sieve, xla as ref_xla
from pfac_tpu_torch.backends import compact, reduce, sieve

BLOCK = sieve.BLOCK


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
         ("3pct", 2 * BLOCK + 4_000), ("sparse", BLOCK + 77), ("all", 4_160)]


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
def test_flags_and_fused_compaction(kind, npad):
    # the device path's pieces in their plain versions: the bitmap of
    # result > 0 padded with zero words to whole blocks (the last block
    # cut), the block counts, then the compaction with thresh = block + 1
    # gathering the ids into zeroed outputs
    res = torch.from_numpy(_result(kind, npad))
    bits, counts = reduce.reduce_flags(res)
    nblocks = -(-npad // BLOCK)
    assert bits.shape[0] == nblocks * BLOCK // 32 and counts.shape[0] == nblocks
    flags = sieve.unpack_bits(bits)
    assert flags[:npad].tolist() == (res > 0).to(torch.uint8).tolist()
    assert not flags[npad:].any()
    assert counts.tolist() == [int((res[b * BLOCK:(b + 1) * BLOCK] > 0).sum())
                               for b in range(nblocks)]
    ids = torch.zeros(npad, dtype=torch.int32)
    pos = torch.zeros(npad, dtype=torch.int32)
    out, cnt = compact.compact(bits, counts, BLOCK + 1, out=pos, values=res,
                               ids=ids)
    assert out is pos
    want = reduce.reduce_plain(res)
    assert int(cnt[0]) == int(want[2])
    assert ids.tolist() == want[0].tolist() and pos.tolist() == want[1].tolist()


def test_reduce_checks_its_input():
    for bad in (torch.zeros(8, dtype=torch.int64), torch.zeros(2, 4,
                                                               dtype=torch.int32)):
        with pytest.raises(ValueError):
            reduce.reduce_from_dense(bad)
    with pytest.raises(ValueError):
        compact.compact(*reduce.reduce_flags(torch.zeros(8, dtype=torch.int32)),
                        BLOCK + 1, values=torch.zeros(8, dtype=torch.int32))
    ids, pos, count = reduce.reduce_from_dense(torch.zeros(0,
                                                           dtype=torch.int32))
    assert ids.numel() == pos.numel() == 0 and int(count) == 0

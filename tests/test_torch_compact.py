"""The survivor compaction on the CPU (``compact.compact`` runs its plain
version there) against a numpy decoding of the bitmap, exact (tolerance 0):
no survivors, every position a survivor, n not a multiple of 32, a survivor
in the last word of the last block, dense blocks skipped, and the dense
threshold exactly. The bitmaps come from the port's plain sieve or from a
seeded numpy generator."""
import numpy as np
import pytest
import torch

import pfac_tpu_torch as pt
from pfac_tpu_torch.backends import compact, sieve
from pfac_tpu_torch.backends.sieve_matcher import npad_for

BLOCK = 8192


def _bits(flags: np.ndarray) -> torch.Tensor:
    """uint8 flags -> int32 bitmap words (bit j of word w: position 32w+j)."""
    return torch.from_numpy(np.packbits(flags.astype(np.uint8),
                                        bitorder="little").view(np.int32))


def _counts(flags: np.ndarray, block: int = BLOCK) -> torch.Tensor:
    return torch.from_numpy(flags.reshape(-1, block).sum(1).astype(np.int32))


def _want(flags: np.ndarray, thresh: int, block: int = BLOCK) -> list[int]:
    per = flags.reshape(-1, block).sum(1)
    keep = np.repeat(per < thresh, block)
    return np.nonzero(flags.astype(bool) & keep)[0].tolist()


def _check(flags: np.ndarray, thresh: int, block: int = BLOCK) -> list[int]:
    bits, counts = _bits(flags), _counts(flags, block)
    got = compact.compact(bits, counts, thresh)
    assert got.dtype == torch.int32
    assert got.tolist() == _want(flags, thresh, block)
    assert torch.equal(sieve.pack_bits(torch.from_numpy(flags)), bits)
    return got.tolist()


def test_no_survivors():
    flags = np.zeros(3 * BLOCK, np.uint8)
    assert _check(flags, BLOCK // 4) == []


def test_every_position_a_survivor():
    flags = np.ones(2 * BLOCK, np.uint8)
    # armed: every block is dense, nothing is listed; disarmed: all
    assert _check(flags, BLOCK // 4) == []
    assert _check(flags, BLOCK + 1) == list(range(2 * BLOCK))


@pytest.mark.parametrize("n", [1, 31, 33, 8191, 8193, 20001])
def test_n_not_a_multiple_of_32(n):
    # the plain sieve on n bytes: positions at and past n never survive
    pats = [b"aaaa", b"aaaab", b"ab"]
    m = pt.Matcher(pats, device="cpu", tile=BLOCK)
    eng = m._engine()
    npad = npad_for(n, eng.tile_rows)
    data = torch.full((n,), ord("a"), dtype=torch.uint8)
    _, bits, counts = sieve.sieve(data, n, npad, eng._sieve, BLOCK)
    pos = compact.compact(bits, counts, BLOCK + 1)
    assert pos.tolist() == list(range(max(n - 3, 0)))
    flags = np.unpackbits(bits.numpy().view(np.uint8), bitorder="little")
    assert pos.tolist() == _want(flags, BLOCK + 1)


def test_survivor_in_the_last_word_of_the_last_block():
    flags = np.zeros(4 * BLOCK, np.uint8)
    flags[[5, BLOCK + 31, 4 * BLOCK - 32, 4 * BLOCK - 1]] = 1
    assert _check(flags, BLOCK // 4) == [5, BLOCK + 31, 4 * BLOCK - 32,
                                         4 * BLOCK - 1]


@pytest.mark.parametrize("seed", range(3))
def test_dense_blocks_skipped(seed):
    rng = np.random.default_rng(seed)
    flags = (rng.random(6 * BLOCK) < 0.01).astype(np.uint8)
    flags[BLOCK:2 * BLOCK] = rng.random(BLOCK) < 0.6       # dense
    flags[4 * BLOCK:5 * BLOCK] = 1                         # dense
    got = _check(flags, BLOCK // 4)
    assert got and not any(BLOCK <= p < 2 * BLOCK or 4 * BLOCK <= p < 5 * BLOCK
                           for p in got)
    assert got == sorted(got)


def test_the_block_threshold_exactly():
    thresh = BLOCK // 4
    flags = np.zeros(3 * BLOCK, np.uint8)
    flags[:thresh - 1] = 1                      # one below: listed
    flags[BLOCK:BLOCK + thresh] = 1             # at the threshold: dense
    flags[2 * BLOCK + 1:2 * BLOCK + thresh + 2] = 1   # above: dense
    got = _check(flags, thresh)
    assert got == list(range(thresh - 1))


def test_larger_blocks_and_bad_shapes():
    block = 3 * BLOCK                           # 24,576: not a power of two
    rng = np.random.default_rng(9)
    flags = (rng.random(4 * block) < 0.02).astype(np.uint8)
    _check(flags, block // 4, block)
    bits, counts = _bits(flags), _counts(flags, block)
    for bad in (torch.zeros(7, dtype=torch.int32),
                torch.zeros(5, dtype=torch.int32),
                torch.zeros(16, dtype=torch.int32), counts.long()):
        with pytest.raises(ValueError):  # no whole number of blocks, a
            compact.compact(bits, bad, block // 4)  # block of 6,144, int64

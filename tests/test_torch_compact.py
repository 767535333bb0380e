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
    got, count = compact.compact(bits, counts, thresh)
    assert got.dtype == count.dtype == torch.int32
    assert count.shape == (1,) and int(count) == got.numel()
    assert got.numel() <= compact.capacity(counts.numel(), block, thresh)
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
    pos, count = compact.compact(bits, counts, BLOCK + 1)
    assert int(count) == pos.numel()
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


def test_capacity_of_both_tiers():
    # 128 MB in 64K blocks: with the escape armed (walk-table tier) a listed
    # block holds at most thresh - 1 survivors; disarmed (CSR tier) the
    # buffer is npad positions
    block = 65536
    nblocks = npad_for(128 << 20) // block
    assert nblocks == 2048
    assert compact.capacity(nblocks, block, block // 4) == 2048 * 16383
    assert 4 * compact.capacity(nblocks, block, block // 4) == 134_209_536
    assert compact.capacity(nblocks, block, block + 1) == nblocks * block
    assert compact.capacity(nblocks, block, 1) == 0    # every block left out
    assert compact.capacity(0, block, block // 4) == 0


@pytest.mark.parametrize("armed", [True, False])
def test_capacity_holds_full_blocks_and_a_cut_last_block(armed):
    # every listed block at its most survivors, and n cutting the last
    # block (its survivors stop 3 positions before n): all fit the buffer
    thresh = BLOCK // 4 if armed else BLOCK + 1
    most = min(thresh - 1, BLOCK)
    rng = np.random.default_rng(int(armed))
    flags = np.zeros(4 * BLOCK, np.uint8)
    for b in range(3):
        flags[b * BLOCK + rng.choice(BLOCK, most, replace=False)] = 1
    n = 3 * BLOCK + 1000
    flags[3 * BLOCK:n - 3] = 1
    got = _check(flags, thresh)
    assert len(got) == 3 * most + 997
    assert compact.capacity(4, BLOCK, thresh) - len(got) == most - 997


@pytest.mark.parametrize("extra", [-1, 0, 1, 300])
@pytest.mark.parametrize("armed", [True, False])
def test_wordwise_chunks_plain(extra, armed):
    # the chunks compact_kernel lists word by word (its device counter):
    # in a listed block's warp rounds (8 chunks of 32 words at 64K), the
    # nonempty chunks of a round of more than compact.ROUND_MAX set bits;
    # a full word in a sparse round is listed lane by lane, and a dense
    # block's chunks count only with the escape disarmed
    block = 65536
    thresh = block // 4 if armed else block + 1
    rng = np.random.default_rng(extra + 2)
    flags = np.zeros((4, 8, 8, 1024), np.uint8)   # blocks, warps, chunks
    rank = rng.random((8, 6 * 1024)).argsort(1).argsort(1)
    flags[0, :, :6] = (rank < compact.ROUND_MAX + extra).reshape(8, 6, 1024)
    flags[1, :, 3, :32] = 1                 # a full word, a sparse round
    flags[2] = 1                            # a dense block
    assert (flags[0].sum((1, 2)) == compact.ROUND_MAX + extra).all()
    assert flags[0, :, :6].any(2).all()     # six nonempty chunks a round
    want = 48 * (extra > 0) + (0 if armed else 64)
    flags = flags.reshape(-1)
    assert compact.wordwise_chunks_plain(
        _bits(flags), _counts(flags, block), thresh) == want

"""The whole slice on the CPU: ``pfac_tpu_torch.Matcher(device="cpu")``
against the reference ``SieveMatcher(interpret=True)`` and the golden model,
bit-exact (tolerance 0)."""
import numpy as np
import pytest
import torch

import pfac_tpu_torch as pt
from pfac_tpu.backends import golden
from pfac_tpu.backends.pallas_sieve import SieveMatcher as RefSieveMatcher
from pfac_tpu_torch.backends import block_walk, compact, sieve
from pfac_tpu_torch.backends.sieve_matcher import npad_for

README = [b"AB", b"ABG", b"BEDE", b"ED"]


def _check(pats, data: bytes, reference: bool = True, **kw):
    m = pt.Matcher(pats, device="cpu", **kw)
    got = m.match(data)
    want = golden.match_dense(m.automaton, data)
    assert got.dtype == np.int32 and got.tolist() == want.tolist()
    if reference:
        ref = RefSieveMatcher(m.automaton, interpret=True).match(data)
        assert got.tolist() == np.asarray(ref).tolist()
    return m, got


def test_conformance():
    m, got = _check(README, b"ABEDEDABG")
    assert got.tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]
    ids, pos, n = m.match_reduce(b"ABEDEDABG")
    assert (n, pos.tolist(), ids.tolist()) == (5, [0, 1, 2, 4, 6],
                                               [1, 3, 4, 4, 2])


def test_match_device_contract():
    m = pt.Matcher(README, device="cpu")
    data = torch.from_numpy(np.frombuffer(b"ABEDEDABG" * 3, np.uint8).copy())
    out = m.match_device(data)
    assert out.dtype == torch.int32 and out.shape[0] == npad_for(27) == 65536
    assert out[:9].tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]
    assert not out[27:].any()
    ids, pos, cnt = m.match_reduce_device(data)
    c = int(cnt)
    g_ids, g_pos, g_n = golden.reduce_result(out[:27].numpy())
    assert c == g_n and pos[:c].tolist() == g_pos.tolist()
    assert ids[:c].tolist() == g_ids.tolist() and not ids[c:].any()
    m.flush_checks()


def test_duplicates_later_id_wins():
    _, got = _check([b"ab", b"ab", b"abcde", b"abcde", b"x", b"x", b"x"],
                    b"zabcdeabxx")
    assert got.tolist() == [0, 4, 0, 0, 0, 0, 2, 0, 7, 7]


@pytest.mark.parametrize("n", [65535, 65536, 65537])
def test_lengths_at_grid_multiples(n):
    rng = np.random.default_rng(n)
    pats = [b"ab", b"abc", b"abcd", b"d", b"abcdabcdab"]
    data = bytearray(rng.integers(97, 101, size=n, dtype=np.uint8).tobytes())
    data[-4:] = b"abcd"
    m = pt.Matcher(pats, device="cpu")
    got = m.match(bytes(data))
    assert got.tolist() == golden.match_edges_batch(m.automaton,
                                                    bytes(data)).tolist()


def test_dense_block_survivors():
    # more than a quarter of a block survives: the port, like the
    # reference, walks the whole block through the dense-block escape
    rng = np.random.default_rng(5)
    pats = [b"aaaa", b"aaaab", b"aaaaaaab", b"aaba", b"ab", b"a"]
    data = bytes(rng.choice(np.frombuffer(b"aaaaaaaaab", np.uint8), 4000))
    m, _ = _check(pats, data, tile=8192)   # the reference's 64-row tile
    eng = m._engine()
    n, npad = len(data), npad_for(len(data), eng.tile_rows)
    t = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    match, bits, counts = sieve.sieve(t, n, npad, eng._sieve, 8192)
    assert int(counts[0]) > 8192 // 4
    assert block_walk.escaped_blocks(counts, npad) == 1
    block_walk.block_walk(t, n, counts, match, eng._walk)
    # compaction lists no survivor of the escaped block
    assert compact.compact(bits, counts, 8192 // 4)[0].numel() == 0
    assert match[:n].tolist() == m.match(data).tolist()


def test_random_rulesets_vs_golden():
    for seed in range(4):
        rng = np.random.default_rng(seed)
        alpha = rng.integers(0, 256, size=int(rng.integers(2, 6))).astype(np.uint8)
        pats = [bytes(alpha[rng.integers(0, len(alpha),
                                         size=int(rng.integers(1, 12)))])
                for _ in range(int(rng.integers(1, 30)))]
        data = bytes(alpha[rng.integers(0, len(alpha),
                                        size=int(rng.integers(1, 2000)))])
        _check(pats, data, reference=False)


def test_stream_equals_whole():
    rng = np.random.default_rng(3)
    pats = [b"HELLO", b"HELLOWORLD", b"LOW", b"W"]
    data = bytearray(rng.integers(65, 91, size=5000, dtype=np.uint8).tobytes())
    for off in (0, 997, 998, 2000, 4990):
        data[off:off + 10] = b"HELLOWORLD"
    data = bytes(data)
    m = pt.Matcher(pats, device="cpu")
    sm = m.stream(min_batch=256)
    out = []
    for off in range(0, len(data), 1000):
        out.append(sm.feed(data[off:off + 1000])[1])
    out.append(sm.finish()[1])
    assert np.concatenate(out).tolist() == golden.match_dense(
        m.automaton, data).tolist()


def test_platform_cpu_and_golden_backend():
    data = b"ABEDEDABG"
    for kw in ({"platform": "cpu"}, {"backend": "golden"}):
        m = pt.Matcher(README, device="cpu", **kw)
        assert m.match(data).tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]


def test_wide_ruleset_takes_the_csr_tier():
    # walk tables past their budget (> 6 MB in the reference layout): the
    # CSR tier serves the ruleset, as in the reference
    rng = np.random.default_rng(1)
    pats = [bytes(rng.integers(0, 256, size=80, dtype=np.uint8))
            for _ in range(3000)]
    m = pt.Matcher(pats, device="cpu")
    eng = m._engine()
    assert eng.walk_tables is None and eng.csr_tables is not None
    data = bytearray(rng.integers(0, 256, size=20000, dtype=np.uint8).tobytes())
    for off in range(0, 19900, 997):
        data[off:off + 80] = pats[int(rng.integers(0, len(pats)))]
    data += pats[8] + pats[7][:79]         # one whole, one cut by the end
    got = m.match(bytes(data))
    want = golden.match_edges_batch(m.automaton, bytes(data))
    assert got.tolist() == want.tolist() and (got > 0).sum() >= 20


def test_unported_tiers_raise():
    # the XLA lockstep walker is not ported: each tier that needs it raises
    for kw in ({"backend": "xla"}, {"platform": "cpu_parallel"},
               {"placement": "hbm"}):
        with pytest.raises(pt.PfacError, match="not ported"):
            pt.Matcher(README, device="cpu", **kw).match(b"ABEDEDABG")


def test_cuda_requested_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(pt.PfacError, match="CUDA"):
        pt.Matcher(README)

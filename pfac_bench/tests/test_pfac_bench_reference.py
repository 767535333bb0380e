"""The plain reference against the PFAC semantics and the port's CPU path.

The port is imported here, in the tests only: the reference itself imports
nothing of it."""
import numpy as np
import pytest
import torch

from pfac_bench import reference
from pfac_bench.layout import Bench

CONFORMANCE = [b"AB", b"ABG", b"BEDE", b"ED"]


def _u8(data: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(data), dtype=torch.uint8)


def brute(patterns, data: bytes) -> list[int]:
    """The definition, position by position."""
    out = []
    for i in range(len(data)):
        best, best_len = 0, 0
        for pid, p in enumerate(patterns, 1):
            if data.startswith(p, i) and len(p) >= best_len:
                best, best_len = pid, len(p)
        out.append(best)
    return out


def test_conformance_dense():
    trie = reference.build(CONFORMANCE)
    got = reference.match_dense(trie, _u8(b"ABEDEDABG"))
    assert got.tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]


def test_conformance_reduce():
    trie = reference.build(CONFORMANCE)
    ids, pos, count = reference.reduce_form(
        reference.match_dense(trie, _u8(b"ABEDEDABG")))
    assert (count, pos.tolist(), ids.tolist()) == (5, [0, 1, 2, 4, 6],
                                                   [1, 3, 4, 4, 2])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_sets_equal_brute_force(seed):
    rng = np.random.default_rng(seed)
    alphabet = b"abc\x00\xff"
    pats = [bytes(rng.choice(list(alphabet), size=int(rng.integers(1, 6))))
            for _ in range(25)]
    pats += [pats[3], pats[0] + b"a"]          # a duplicate, a prefix chain
    data = bytes(rng.choice(list(alphabet), size=400))
    trie = reference.build(pats)
    assert reference.match_dense(trie, _u8(data), block=64).tolist() == \
        brute(pats, data)


def test_n_cuts_walks_and_max_depth():
    trie = reference.build([b"abcd", b"ab"])
    data = _u8(b"abcdabcd")
    assert reference.match_dense(trie, data, 6).tolist() == [1, 0, 0, 0, 2, 0]
    assert reference.match_dense(trie, data, max_depth=3).tolist() == \
        [2, 0, 0, 0, 2, 0, 0, 0]


def test_empty_and_single_byte_sets():
    with pytest.raises(ValueError):
        reference.build([])
    with pytest.raises(ValueError):
        reference.build([b"a", b""])
    trie = reference.build([b"a", b"b"])
    assert reference.match_dense(trie, _u8(b"abc")).tolist() == [1, 2, 0]


def _bench_patterns(kind: str, k: int) -> list[bytes]:
    return Bench.load().module("rulesets", kind).make(
        {"seed": 3, "patterns": k})


def _corpus(patterns, n: int, share: float, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return Bench.load().module("corpora", "planted_text").make(
        {"planted_share": share}, patterns, n, np.random.default_rng(seed),
        gen, torch.device("cpu"))


@pytest.mark.parametrize("seed", [11, 12])
def test_snort_like_equal_to_port_cpu(seed):
    from pfac_tpu_torch import Matcher
    pats = _bench_patterns("snort_like", 2000)
    data = _corpus(pats, 1 << 16, 0.05, seed)
    want = Matcher(pats, device="cpu").match(data.numpy())
    got = reference.match_dense(reference.build(pats), data)
    assert (got.numpy() == want).all() and (want > 0).sum() > 100


def test_random_signatures_equal_to_port_csr_tier(monkeypatch):
    """Long random-byte signatures through the port's CSR tier (forced, as the
    port's own tests force it), dense and reduced."""
    from pfac_tpu_torch import Matcher
    from pfac_tpu_torch.backends import sieve_matcher
    monkeypatch.setattr(sieve_matcher, "build_walk_tables_gated",
                        lambda *a: None)
    rng = np.random.default_rng(3)
    lens = np.clip(rng.gamma(3.0, 18.0, size=3000) + 8, 8, 200).astype(int)
    pats = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
            for n in lens]
    data = _corpus(pats, 1 << 16, 0.02, 5)
    m = Matcher(pats, device="cpu")
    assert m._engine().csr_tables is not None
    dense = reference.match_dense(reference.build(pats), data)
    assert (dense.numpy() == m.match(data.numpy())).all()
    ids, pos, count = m.match_reduce(data.numpy())
    rids, rpos, rcount = reference.reduce_form(dense)
    assert count == rcount > 10
    assert (ids == rids.numpy()).all() and (pos == rpos.numpy()).all()

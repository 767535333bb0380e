"""The port's CSR tier on the CPU against the reference's, bit-exact
(tolerance 0): tables field by field against ``xla_csr.build_csr_tables``,
the plain CSR walk against ``xla_csr.csr_oracle_walk`` at every position,
and ``Matcher(device="cpu")`` with the walk tables forced off against
``SieveMatcher(interpret=True)`` (its CSR tail) and the golden model."""
import numpy as np
import pytest
import torch

import pfac_tpu.backends.pallas_sieve as S
import pfac_tpu_torch as pt
from pfac_tpu.backends import golden, xla_csr
from pfac_tpu_torch.backends import csr_walk, sieve_matcher
from pfac_tpu_torch.backends.convert import from_jax_csr_tables
from pfac_tpu_torch.backends.csr_tables import build_csr_tables
from pfac_tpu_torch.core import Automaton


def _rulesets():
    rng = np.random.default_rng(11)
    oracle_random = list(dict.fromkeys(
        bytes(rng.integers(97, 105, size=int(k)).astype(np.uint8))
        for k in rng.integers(4, 40, size=60)))
    rng = np.random.default_rng(6)
    base = bytes(rng.integers(65, 91, size=243, dtype=np.uint8))
    rng = np.random.default_rng(5)
    parity = list(dict.fromkeys(
        bytes(rng.integers(97, 107, size=int(k)).astype(np.uint8))
        for k in rng.integers(1, 30, size=80)))
    return {
        # tests/test_xla_csr.py rulesets
        "oracle_basic": [b"wxyzab", b"wxyz", b"q", b"longerpatternhere"],
        "oracle_random": oracle_random,
        "chaining_hot_state": [b"HOT!" + bytes([x, 120, 121, 122])
                               for x in range(97, 117)],
        "deep_stages": [base[:k] for k in (4, 15, 16, 17, 47, 48, 49, 111,
                                           112, 113, 243)],
        "parity_random": parity,
        # chains at every key length, finals merged with transitions,
        # duplicates (later ID wins) and key bytes >= 0x80
        "chains_all_klen": ([b"PREFIX!!" + bytes([i]) for i in range(30)]
                            + [b"PREFIX!!" + bytes([i, i]) for i in range(30)]
                            + [b"PREFIX!!" + bytes([i] * 4) for i in range(10)]
                            + [b"PREFIX!!" + bytes([i] * 4 + [5])
                               for i in range(30)]),
        "duplicates_high_bytes": [b"\xff\x80\x81\xfe", b"\xff\x80\x81\xfe",
                                  b"\xff\x80\x81\xfe\x90\x91\x92\x93\x94",
                                  b"\x80\x00\x00\x00\xc3", b"ab", b"abcd",
                                  b"abcd"],
    }


RULESETS = _rulesets()


def _corpus(pats, seed: int, n: int = 3000) -> bytes:
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"".join(pats), np.uint8)
    data = bytearray(alpha[rng.integers(0, alpha.size, size=n)].tobytes())
    for off in range(0, n - 250, 97):
        p = pats[int(rng.integers(0, len(pats)))]
        data[off:off + len(p)] = p
    return bytes(data) + pats[-1][:-1]       # a match cut by the end


@pytest.mark.parametrize("name", sorted(RULESETS))
def test_tables_equal(name):
    a = Automaton.from_patterns(RULESETS[name])
    ref, got = xla_csr.build_csr_tables(a), build_csr_tables(a)
    assert np.array_equal(ref.entry_rows, got.entry_rows)
    assert ref.entry_rows.dtype == got.entry_rows.dtype == np.int32
    assert (ref.entry_lgb, ref.entry_width, ref.max_len) == (
        got.entry_lgb, got.entry_width, got.max_len)
    assert [(s.depth, s.chain) for s in ref.steps] == [
        (s.depth, s.chain) for s in got.steps]
    for rs, gs in zip(ref.steps, got.steps):
        assert gs.rows.dtype == np.int32 and np.array_equal(rs.rows, gs.rows)
    if name in ("chaining_hot_state", "chains_all_klen"):
        assert any(s.chain >= 1 for s in got.steps)
    # the reference's tables carried across give the same device arena
    mine, carried = got.to_device("cpu"), from_jax_csr_tables(ref).to_device(
        "cpu")
    assert torch.equal(mine.arena, carried.arena)
    assert torch.equal(mine.desc, carried.desc) and mine.rows == carried.rows


def test_no_long_patterns_no_tables():
    assert build_csr_tables(Automaton.from_patterns([b"abc", b"x"])) is None


@pytest.mark.parametrize("name", sorted(RULESETS))
def test_plain_walk_equals_oracle(name):
    pats = RULESETS[name]
    a = Automaton.from_patterns(pats)
    ref = xla_csr.build_csr_tables(a)
    data = _corpus(pats, seed=len(name))
    for n in (len(data), len(data) - 2):
        out = torch.zeros(len(data), dtype=torch.int32)
        csr_walk.csr_walk(torch.from_numpy(np.frombuffer(data, np.uint8).copy()),
                          n, torch.arange(n, dtype=torch.int32), out,
                          build_csr_tables(a).to_device("cpu"))
        want = [xla_csr.csr_oracle_walk(ref, data, p, n) for p in range(n)]
        assert out.tolist() == want + [0] * (len(data) - n)
        assert any(want)


@pytest.mark.parametrize("count", [0, 1, 6, 50])
def test_positions_past_the_count_are_not_walked(count):
    # the pipeline's contract: `pos` is a buffer longer than the survivors,
    # their number a 1-element tensor; the buffer's words past the count are
    # positions < n that would match, and must not be walked
    pats = RULESETS["deep_stages"]
    data = _corpus(pats, seed=3)
    n = len(data)
    a = Automaton.from_patterns(pats)
    tabs = build_csr_tables(a).to_device("cpu")
    ref = xla_csr.build_csr_tables(a)
    starts = [p for p in range(n) if xla_csr.csr_oracle_walk(ref, data, p, n)]
    assert len(starts) >= 12
    rng = np.random.default_rng(count)
    pos = torch.tensor(rng.permutation(starts)[:12], dtype=torch.int32)
    t = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    out = torch.zeros(n, dtype=torch.int32)
    csr_walk.csr_walk(t, n, pos, out, tabs,
                      torch.tensor([count], dtype=torch.int32))
    want = torch.zeros(n, dtype=torch.int32)
    csr_walk.csr_walk_plain(t, n, pos[:count].clone(), want, tabs)
    assert torch.equal(out, want)
    assert int((out != 0).sum()) == min(count, pos.numel())


def test_entry_rows_padded_to_whole_vectors():
    # the device layout pads a bucket row to a width that is a multiple of
    # 4 with empty triples, so every row loads as whole 16-byte vectors
    a = Automaton.from_patterns(RULESETS["parity_random"])
    ct = build_csr_tables(a)
    packed = ct.to_device("cpu")
    width = packed.rows[0][2]
    assert width % 4 == 0 and 0 <= width - ct.entry_width < 4
    nb = ct.entry_rows.shape[0]
    entry = packed.arena[:nb * 3 * width].view(nb, 3 * width).numpy()
    assert np.array_equal(entry[:, :3 * ct.entry_width], ct.entry_rows)
    assert not entry[:, 3 * ct.entry_width:].any()
    assert all(off % 4 == 0 for off, *_ in packed.rows[1:])


def _csr_matchers(pats, monkeypatch):
    """Both packages' matchers with the walk tables forced off."""
    monkeypatch.setattr(S, "build_walk_tables_gated", lambda *a: None)
    monkeypatch.setattr(sieve_matcher, "build_walk_tables_gated",
                        lambda *a: None)
    m = pt.Matcher(pats, device="cpu")
    eng = m._engine()
    assert eng.walk_tables is None and eng.csr_tables is not None
    ref = S.SieveMatcher(m.automaton, interpret=True)
    assert ref.walk_tables is None and ref.csr_tables is not None
    return m, ref


def _boundary_straddle() -> bytes:
    data = bytearray(3000)
    for off in (0, 1, 63, 64, 120, 127, 128, 1020, 1023, 1024, 2040):
        data[off:off + 12] = b"HELLOWORLD!!"
    return bytes(data)


def _pipeline_case(name: str):
    if name == "parity_random":
        rng = np.random.default_rng(5)
        pats = RULESETS["parity_random"]
        return pats, bytes(rng.integers(97, 107, size=5000, dtype=np.uint8))
    if name == "deep_stages":
        pats = RULESETS["deep_stages"]
        return pats, b"\x00" * 37 + pats[-1] + b"\x00" * 100
    if name == "boundary_straddle":
        return [b"HELLOWORLD!!", b"HELL", b"HE"], _boundary_straddle()
    return [b"abcdef", b"abcd"], b"zzzzabcd"      # truncated at the end


@pytest.mark.parametrize("name", ["parity_random", "deep_stages",
                                  "boundary_straddle", "truncated_end"])
def test_csr_tier_end_to_end(name, monkeypatch):
    pats, data = _pipeline_case(name)
    m, ref = _csr_matchers(pats, monkeypatch)
    got = m.match(data)
    want = golden.match_edges_batch(m.automaton, data)
    assert got.tolist() == want.tolist()
    assert got.tolist() == np.asarray(ref.match(data)).tolist()
    m.flush_checks()


@pytest.mark.parametrize("force_csr", [False, True])
def test_wide_33k_ruleset(force_csr, monkeypatch):
    # pfac_tpu/tools/device_fuzz.py's wide case: > 32767 pattern IDs
    rng = np.random.default_rng(2)
    keys = rng.choice(1 << 16, size=33000, replace=False)
    longs = list(dict.fromkeys(
        bytes(rng.integers(0, 256, size=int(np.clip(rng.gamma(1.8, 4.0) + 1,
                                                    4, 64))).astype(np.uint8))
        for _ in range(80)))[:50]
    pats = [bytes([k >> 8, k & 0xFF]) for k in keys] + longs
    n = 120_000
    data = bytearray(rng.integers(0, 256, size=n).astype(np.uint8).tobytes())
    for _ in range(40):
        p = pats[int(rng.integers(0, len(pats)))]
        off = int(rng.integers(0, n - len(p) + 1))
        data[off:off + len(p)] = p
    for i, p in enumerate(longs):
        data[1000 * i:1000 * i + len(p)] = p
    if force_csr:
        monkeypatch.setattr(sieve_matcher, "build_walk_tables_gated",
                            lambda *a: None)
    m = pt.Matcher(pats, device="cpu")
    assert m.automaton.num_final_states > 0x7FFF
    assert (m._engine().csr_tables is not None) == force_csr
    got = m.match(bytes(data))
    want = golden.match_edges_batch(m.automaton, bytes(data))
    assert got.tolist() == want.tolist()
    assert (got > 0x7FFF).any()
    lens = np.array([len(p) for p in m.automaton.sorted_patterns])
    ids = np.asarray(m.automaton.pattern_ids)
    deep = set(ids[lens >= 4].tolist())
    assert sum(int(x) in deep for x in got) >= len(longs)

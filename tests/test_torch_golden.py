"""The port's vectorized dense oracle ``golden.match_dense_batch`` against
the reference's ``pfac_tpu.backends.golden.match_dense_batch`` and the
port's serial ``match_dense``, on the same seeded inputs, bit-exact
(tolerance 0)."""
import numpy as np
import pytest

import pfac_tpu_torch as pt
from pfac_tpu import Automaton as RefAutomaton
from pfac_tpu.backends import golden as ref_golden
from pfac_tpu_torch.backends import golden
from pfac_tpu_torch.experiments import rulesets

README = [b"AB", b"ABG", b"BEDE", b"ED"]


def _snort_planted(n: int = 1 << 16):
    pats = rulesets.snort_like_patterns()
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, size=n, dtype=np.uint8)
    for off in rng.integers(0, n - 250, size=n // 300):
        p = pats[int(rng.integers(0, len(pats)))]
        data[off:off + len(p)] = np.frombuffer(p, np.uint8)
    return pats, data.tobytes(), {}


def _chunk_boundary():
    # patterns straddling the boundary of 4,096-position chunks, and one
    # ending on the input's last byte
    pats = [b"xyzw", b"xyzwvu", b"wvutsr", b"q"]
    rng = np.random.default_rng(4)
    data = bytearray(rng.integers(97, 123, size=3 * 4096 + 7,
                                  dtype=np.uint8).tobytes())
    data[4093:4099] = b"xyzwvu"
    data[8190:8196] = b"wvutsr"
    data[-4:] = b"xyzw"
    return pats, bytes(data), {"chunk": 4096}


def _one_byte():
    pats = [bytes([c]) for c in (0, 7, 97, 98, 255)]
    rng = np.random.default_rng(5)
    data = rng.choice(np.array([0, 7, 97, 98, 255, 3], np.uint8), size=5000)
    return pats, data.tobytes(), {"chunk": 1000}


CASES = {
    "conformance": lambda: (README, b"ABEDEDABG", {}),
    "snort_64k_planted": _snort_planted,
    "chunk_4096_boundary": _chunk_boundary,
    "one_byte_patterns": _one_byte,
    "empty_input": lambda: (README, b"", {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_match_dense_batch_equals_reference(case):
    pats, data, kw = CASES[case]()
    a, ra = pt.Automaton.from_patterns(pats), RefAutomaton.from_patterns(pats)
    got = golden.match_dense_batch(a, data, **kw)
    want = ref_golden.match_dense_batch(ra, data, **kw)
    assert got.dtype == np.int32 and got.shape == (len(data),)
    assert got.tolist() == want.tolist()
    assert got.tolist() == golden.match_dense(a, data).tolist()
    if case == "conformance":
        assert got.tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]
    if case == "chunk_4096_boundary":
        assert got[4093] and got[8190] and got[len(data) - 4]
    if case == "snort_64k_planted":
        assert (got > 0).sum() > 1000
        # the chunk does not change the result
        assert np.array_equal(got, golden.match_dense_batch(a, data,
                                                            chunk=4096))

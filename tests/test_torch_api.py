"""The port's Pythonic Matcher API, its C-style API
(``pfac_tpu_torch.runtime.capi``), its exports and its examples, on the
CPU (``device="cpu"``): the counterparts of ``tests/test_api.py``, held to
the same expected values and, where the reference computes one, to the
reference's result on the same input."""
import os
import threading

import numpy as np
import pytest
import torch

import pfac_tpu
import pfac_tpu_torch as pt
from pfac_tpu.runtime import capi as ref_capi
from pfac_tpu_torch import Matcher, PfacError, PfacStatus, get_error_string
from pfac_tpu_torch.backends import golden
from pfac_tpu_torch.backends.sieve_matcher import SieveMatcher
from pfac_tpu_torch.backends.xla import XlaMatcher
from pfac_tpu_torch.runtime import capi

README = [b"AB", b"ABG", b"BEDE", b"ED"]
EXPECT = [1, 3, 4, 0, 4, 0, 2, 0, 0]


def _u8(data: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy())


class TestMatcher:
    def test_basic(self):
        m = Matcher(README, tile=64, device="cpu")
        assert m.match(b"ABEDEDABG").tolist() == EXPECT

    def test_platform_cpu_golden(self):
        m = Matcher(README, platform="cpu", device="cpu")
        assert m.match(b"ABEDEDABG").tolist() == EXPECT

    def test_platform_cpu_parallel(self):
        m = Matcher(README, platform="cpu_omp", tile=64, device="cpu")
        assert isinstance(m._engine(), XlaMatcher)
        assert m.match(b"ABEDEDABG").tolist() == EXPECT

    def test_perf_mode_switch(self):
        m = Matcher(README, tile=64, device="cpu")
        dense = m.match(b"ABEDEDABG")
        m.set_perf_mode("hash")
        hashed = m.match(b"ABEDEDABG")
        assert dense.tolist() == hashed.tolist() == EXPECT

    def test_match_reduce(self):
        m = Matcher(README, tile=64, device="cpu")
        ids, pos, n = m.match_reduce(b"ABEDEDABG")
        assert (n, pos.tolist(), ids.tolist()) == (5, [0, 1, 2, 4, 6],
                                                   [1, 3, 4, 4, 2])

    def test_str_patterns(self):
        m = Matcher(["ab", "cd"], tile=32, device="cpu")
        assert m.match(b"abcd").tolist() == [1, 0, 2, 0]

    def test_empty_input(self):
        m = Matcher([b"x"], tile=32, device="cpu")
        assert m.match(b"").tolist() == []
        ids, pos, n = m.match_reduce(b"")
        assert n == 0

    def test_doc_dump(self):
        m = Matcher([b"AB"], tile=32, device="cpu")
        assert "Transition table" in m.dump_transition_table()
        assert "time-driven" in m.memory_usage()
        ref = pfac_tpu.Matcher([b"AB"], tile=32)
        assert m.dump_transition_table() == ref.dump_transition_table()
        assert m.memory_usage() == ref.memory_usage()


def _handle(**kw):
    handle = []
    assert capi.PFAC_create(handle, device="cpu", **kw) == PfacStatus.SUCCESS
    return handle[0]


class TestCapi:
    def test_full_flow(self, example_pattern_path, example_input):
        h = _handle()
        assert capi.PFAC_setPlatform(h, capi.PFAC_PLATFORM_GPU) == PfacStatus.SUCCESS
        assert capi.PFAC_setPerfMode(h, capi.PFAC_TIME_DRIVEN) == PfacStatus.SUCCESS
        assert capi.PFAC_readPatternFromFile(h, example_pattern_path) == PfacStatus.SUCCESS
        n = len(example_input)
        result = np.zeros(n, dtype=np.int32)
        assert capi.PFAC_matchFromHost(h, example_input, n, result) == PfacStatus.SUCCESS
        assert result.tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0, 0]
        assert capi.PFAC_destroy(h) == PfacStatus.SUCCESS
        assert h.matcher is None

    def test_reduce_flow(self, example_pattern_path, example_input):
        h = _handle()
        capi.PFAC_setPerfMode(h, capi.PFAC_SPACE_DRIVEN)
        capi.PFAC_readPatternFromFile(h, example_pattern_path)
        n = len(example_input)
        ids = np.zeros(n, dtype=np.int32)
        pos = np.zeros(n, dtype=np.int32)
        cnt = []
        st = capi.PFAC_matchFromHostReduce(h, example_input, n, ids, pos, cnt)
        assert st == PfacStatus.SUCCESS
        assert cnt[0] == 5
        assert pos[:5].tolist() == [0, 1, 2, 4, 6]
        assert ids[:5].tolist() == [1, 3, 4, 4, 2]

    def test_error_paths(self):
        assert capi.PFAC_destroy(None) == PfacStatus.INVALID_HANDLE
        assert capi.PFAC_setPlatform(None, 0) == PfacStatus.INVALID_HANDLE
        assert capi.PFAC_create(None) == PfacStatus.INVALID_HANDLE
        h = _handle()
        assert capi.PFAC_setPlatform(h, 99) == PfacStatus.INVALID_PARAMETER
        assert capi.PFAC_setPerfMode(h, 99) == PfacStatus.INVALID_PARAMETER
        assert capi.PFAC_setTextureMode(h, 99) == PfacStatus.INVALID_PARAMETER
        assert capi.PFAC_readPatternFromFile(h, "/nonexistent") == PfacStatus.FILE_OPEN_ERROR
        assert capi.PFAC_readPatternFromFile(h, None) == PfacStatus.INVALID_PARAMETER
        r = np.zeros(4, dtype=np.int32)
        assert capi.PFAC_matchFromHost(h, b"abcd", 4, r) == PfacStatus.PATTERNS_NOT_READY
        assert capi.PFAC_dumpTransitionTable(h) == PfacStatus.PATTERNS_NOT_READY
        assert capi.PFAC_memoryUsage(h) == PfacStatus.PATTERNS_NOT_READY
        # the same codes as the reference's
        ref = []
        ref_capi.PFAC_create(ref)
        assert ref_capi.PFAC_setPlatform(ref[0], 99) == capi.PFAC_setPlatform(h, 99)

    def test_error_strings(self):
        assert "successful" in get_error_string(PfacStatus.SUCCESS)
        assert "PFAC_readPatternFromFile" in get_error_string(PfacStatus.PATTERNS_NOT_READY)
        assert capi.PFAC_getErrorString(PfacStatus.INVALID_HANDLE).startswith(
            "PFAC_STATUS_INVALID_HANDLE"
        )
        for st in PfacStatus:
            assert capi.PFAC_getErrorString(st) == ref_capi.PFAC_getErrorString(
                int(st))

    def test_dump_and_memory(self, example_pattern_path, tmp_path, capsys):
        h = _handle()
        capi.PFAC_readPatternFromFile(h, example_pattern_path)
        with open(tmp_path / "table.txt", "w") as f:
            assert capi.PFAC_dumpTransitionTable(h, f) == PfacStatus.SUCCESS
        text = (tmp_path / "table.txt").read_text()
        assert "number of states = 11" in text
        assert capi.PFAC_memoryUsage(h) == PfacStatus.SUCCESS
        assert "time-driven" in capsys.readouterr().out


class TestConcurrentHandles:
    """Independent handles driven from concurrent host threads need no
    global state."""

    def test_two_threads_independent_matchers(self):
        pats_b = [b"s", b"h", b"he", b"she", b"hers", b"her", b"his", b"iis",
                  b"is", b"ii"]
        exp_b = golden.match_dense(pt.Automaton.from_patterns(pats_b),
                                   b"sheshershisiis").tolist()
        results, errors = {}, []

        def work(name, pats, data, expected):
            try:
                m = Matcher(pats, platform="cpu_parallel", tile=64)
                for _ in range(3):
                    results[name] = m.match(data).tolist()
                    assert results[name] == expected
            except Exception as e:  # pragma: no cover
                errors.append((name, e))

        t1 = threading.Thread(target=work, args=("a", README, b"ABEDEDABG",
                                                 EXPECT))
        t2 = threading.Thread(target=work, args=("b", pats_b,
                                                 b"sheshershisiis", exp_b))
        t1.start(); t2.start()
        t1.join(timeout=120); t2.join(timeout=120)
        assert not t1.is_alive() and not t2.is_alive()
        assert not errors, errors
        assert results["a"] == EXPECT and results["b"] == exp_b


class TestPlacementModes:
    def test_hbm_placement_forces_xla(self):
        m = Matcher(README, placement="hbm", tile=64, device="cpu")
        assert isinstance(m._engine(), XlaMatcher)
        assert m.match(b"ABEDEDABG").tolist() == EXPECT

    def test_vmem_placement_forces_sieve(self):
        m = Matcher(README, placement="texture_on", device="cpu")
        assert isinstance(m._engine(), SieveMatcher)
        assert m.match(b"ABEDEDABG").tolist() == EXPECT


def _read(h, example_pattern_path):
    assert capi.PFAC_readPatternFromFile(h, example_pattern_path) == PfacStatus.SUCCESS


class TestDeviceApis:
    @pytest.mark.parametrize("texture", ["auto", "hbm"])
    def test_match_from_device_capi(self, example_pattern_path, texture):
        h = _handle()
        if texture == "hbm":
            capi.PFAC_setTextureMode(h, capi.PFAC_TEXTURE_OFF)
        _read(h, example_pattern_path)
        d_out = []
        st = capi.PFAC_matchFromDevice(h, _u8(b"ABEDEDABG"), 9, d_out)
        assert st == PfacStatus.SUCCESS
        assert d_out[0][:9].tolist() == EXPECT and not d_out[0][9:].any()

    @pytest.mark.parametrize("texture", ["auto", "hbm"])
    def test_match_from_device_reduce_capi(self, example_pattern_path,
                                           texture):
        h = _handle()
        if texture == "hbm":
            capi.PFAC_setTextureMode(h, capi.PFAC_TEXTURE_OFF)
        _read(h, example_pattern_path)
        d_ids, d_pos, h_num = [], [], []
        st = capi.PFAC_matchFromDeviceReduce(h, _u8(b"ABEDEDABG"), 9, d_ids,
                                             d_pos, h_num)
        assert st == PfacStatus.SUCCESS
        c = h_num[0]
        assert isinstance(c, int) and c == 5
        assert d_pos[0][:c].tolist() == [0, 1, 2, 4, 6]
        assert d_ids[0][:c].tolist() == [1, 3, 4, 4, 2]
        assert not d_ids[0][c:].any() and not d_pos[0][c:].any()


class _PendingError:
    """An engine whose device calls leave an error pending until
    flush_checks, as an engine with deferred checks would (the port's own
    engines defer none)."""

    def __init__(self, eng):
        self.eng, self.pending = eng, False

    def match_device(self, data):
        self.pending = True
        return self.eng.match_device(data)

    def match_reduce_device(self, data):
        self.pending = True
        return self.eng.match_reduce_device(data)

    def flush_checks(self):
        if self.pending:
            self.pending = False
            raise PfacError(PfacStatus.INTERNAL_ERROR, "deferred overflow")


class TestDeferredErrorDiscipline:
    """C-API calls report device-path errors per call, unless async checks
    are on; PFAC_synchronize reports what the engines deferred."""

    def _handle_with_pending(self, example_pattern_path):
        h = _handle()
        _read(h, example_pattern_path)
        m = h.matcher
        key = (m.platform, m.perf_mode, m.backend, m.placement)
        m._engines[key] = _PendingError(m._engine())
        return h

    def test_match_from_device_reports_error_same_call(self,
                                                       example_pattern_path):
        h = self._handle_with_pending(example_pattern_path)
        d_out = []
        st = capi.PFAC_matchFromDevice(h, _u8(b"a" * 4500), 4500, d_out)
        assert st == PfacStatus.INTERNAL_ERROR
        assert d_out == []   # no incomplete result handed to the caller
        ids, pos, cnt = [], [], []
        st = capi.PFAC_matchFromDeviceReduce(h, _u8(b"AB"), 2, ids, pos, cnt)
        assert st == PfacStatus.INTERNAL_ERROR and ids == pos == cnt == []

    def test_async_check_mode_defers_to_synchronize(self,
                                                    example_pattern_path):
        h = self._handle_with_pending(example_pattern_path)
        assert capi.PFAC_setAsyncCheckMode(h, True) == PfacStatus.SUCCESS
        d_out = []
        st = capi.PFAC_matchFromDevice(h, _u8(b"a" * 4500), 4500, d_out)
        assert st == PfacStatus.SUCCESS and len(d_out) == 1
        assert capi.PFAC_synchronize(h) == PfacStatus.INTERNAL_ERROR
        assert capi.PFAC_synchronize(h) == PfacStatus.SUCCESS
        assert capi.PFAC_setAsyncCheckMode(None, True) == \
            PfacStatus.INVALID_HANDLE

    def test_synchronize_flushes_raw_engine_calls(self, example_pattern_path):
        h = self._handle_with_pending(example_pattern_path)
        h.matcher._engine().match_device(_u8(b"a" * 4500))   # raw engine
        assert capi.PFAC_synchronize(h) == PfacStatus.INTERNAL_ERROR
        assert capi.PFAC_synchronize(h) == PfacStatus.SUCCESS  # drained

    def test_synchronize_clean(self):
        h = _handle()
        assert capi.PFAC_synchronize(h) == PfacStatus.SUCCESS
        assert capi.PFAC_synchronize(None) == PfacStatus.INVALID_HANDLE


def test_exports_cover_the_reference():
    assert set(pfac_tpu.__all__) <= set(pt.__all__)
    assert pt.__version__ == pfac_tpu.__version__
    from pfac_tpu_torch import (ParsedPatterns, StreamMatcher,
                                parse_pattern_bytes, parse_pattern_file,
                                patterns_from_list)
    assert StreamMatcher.__name__ == "StreamMatcher" and callable(
        parse_pattern_file)
    for name in pt.__all__:
        assert getattr(pt, name).__module__.startswith("pfac_tpu_torch")
    assert isinstance(parse_pattern_bytes(b"AB\nABG\n"), ParsedPatterns)
    assert parse_pattern_bytes(b"AB\nABG\n").num_patterns == 2
    assert patterns_from_list(README).max_pattern_len == 4


def test_handle_device_defaults_to_cuda(example_pattern_path):
    handle = []
    assert capi.PFAC_create(handle) == PfacStatus.SUCCESS
    assert handle[0].device == "cuda"
    if not torch.cuda.is_available():
        # the device platform needs the GPU; the CPU platform does not
        assert capi.PFAC_readPatternFromFile(
            handle[0], example_pattern_path) == PfacStatus.INVALID_PARAMETER
        assert capi.PFAC_setPlatform(handle[0], capi.PFAC_PLATFORM_CPU) == \
            PfacStatus.SUCCESS
        _read(handle[0], example_pattern_path)
        r = np.zeros(9, dtype=np.int32)
        assert capi.PFAC_matchFromHost(handle[0], b"ABEDEDABG", 9, r) == \
            PfacStatus.SUCCESS and r.tolist() == EXPECT


@pytest.mark.parametrize("name", ["simple_example", "simple_example_reduce"])
def test_examples(name, tmp_path, capsys):
    import importlib

    mod = importlib.import_module(f"pfac_tpu_torch.examples.{name}")
    argv = ["--device", "cpu"]
    if name == "simple_example":
        argv += ["--table", str(tmp_path / "table.txt")]
    assert mod.main(argv) == 0
    out = capsys.readouterr().out
    if name == "simple_example":
        assert "position |  matched pattern ID" in out
        assert "number of states = 11" in (tmp_path / "table.txt").read_text()
        assert [ln.split() for ln in out.splitlines()[1:]] == [
            ["0", "1"], ["1", "3"], ["2", "4"], ["4", "4"], ["6", "2"]]
    else:
        assert out.startswith("num_matched = 5\n")
        assert "At position    6, match pattern 2" in out
    assert os.path.exists(mod.PATTERN_FILE if name == "simple_example"
                          else mod.INPUT_FILE)

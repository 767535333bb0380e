"""Same-card A/B of the device reduce, G1 and the main path's compaction
between checkouts of the repository.

    python -m pfac_tpu_torch.experiments.kernel_ab DIR_A DIR_B [DIR ...]

As ``match_ab``: one worker process per argument, in the order given (so
``parent . . parent`` runs the trees in turns on one card), each importing
``pfac_tpu_torch`` from its checkout and building its kernels there, with
the corpora made from this checkout's seeds (``match_ab.corpora`` and the
F1 corpus of ``chip_smoke.py``). A worker prints one JSON line per
measurement:

* ``reduce``, per corpus: ``reduce.reduce_from_dense`` on the corpus's
  ``match_device`` result, the CUDA-event median over batches of 10 calls
  (``ms``), the torch.profiler device ms of each kernel it launches, the
  bound (12 B a position over 3.35 TB/s), ``torch.nonzero(result > 0)``
  over batches of 10, and a fingerprint of the output;
* ``compact``, on the random, DEFCON-like and mixed corpora: the main
  path's ``compact.compact`` on K1's bitmap, profiler ms by kernel;
* ``G1``: ``gathers.word_gather`` on E2's ``take_grid`` (4M indices into
  the 66,560-word pair table), E1 C/D at W = 4096 and the E6 planes at
  W = 8192 (16M indices each), in every placement the tree has and its
  default, each batched and by the profiler, beside ``torch.take``'s
  kernel; the forced placements are run twice, in turns (forward, then
  backward).

It uses only the API every slice of the port since the seventh has.
Without CUDA it exits 1.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
MB = 1 << 20
HBM = 3.35e12              # H100 SXM device memory, bytes/s (data sheet)


def _match_ab():
    spec = importlib.util.spec_from_file_location(
        "_ab_match_ab", os.path.join(HERE, "match_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _f1(pt, rs, dev):
    """chip_smoke.py's F1 corpus: 17,000 random 6-byte patterns (seed
    17000) and zzzz, zzzzzzzz on 4 MB with one dense block of z."""
    import numpy as np

    frng = np.random.default_rng(17000)
    fpats = [bytes(frng.integers(0, 256, size=6, dtype=np.uint8))
             for _ in range(17000)] + [b"zzzz", b"zzzzzzzz"]
    mf = pt.Matcher(fpats, device=dev)
    block = mf._engine().tile_rows * 128
    f1 = rs.mixed_density(np.random.default_rng(5), fpats, 4 * MB, 4 * MB)
    f1[5 * block:6 * block] = ord("z")
    return "f1_entry_tables", mf, f1


def _gather_cases(dev):
    """(name, table, idx): E2 take_grid 4M, E1 C/D W=4096, E6 W=8192, as
    the modules of the tree make them (seeded numpy)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    e2 = torch.arange(66560, dtype=torch.int32, device=dev)
    e2_idx = rng.integers(0, 66049, size=4 << 20).astype(np.int32)
    out = [("E2 take_grid 4194304", e2, torch.from_numpy(e2_idx).to(dev))]
    for name, w in (("E1 C/D W=4096", 4096), ("E6 planes W=8192", 8192)):
        rng = np.random.default_rng(0)
        flat = rng.integers(0, 1 << 20, size=w).astype(np.int32)
        idx = rng.integers(0, w, size=16 << 20).astype(np.int32)
        out.append((name, torch.from_numpy(flat).to(dev),
                    torch.from_numpy(idx).to(dev)))
    return out


def worker(tree: str) -> int:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import pfac_tpu_torch as pt

    if not torch.cuda.is_available():
        print("no GPU (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    assert os.path.abspath(pt.__file__).startswith(os.path.abspath(tree))
    from pfac_tpu_torch.backends import block_walk, compact, reduce, sieve
    from pfac_tpu_torch.backends.sieve_matcher import npad_for
    from pfac_tpu_torch.experiments import gathers

    ab = _match_ab()
    dev = torch.device("cuda:0")
    cases = ab.corpora(pt, dev) + [_f1(pt, ab._rulesets(), dev)]
    emit = lambda **kw: print(json.dumps({"tree": tree, **kw}), flush=True)
    for name, mt, host in cases:
        d = torch.from_numpy(host).to(dev)
        res = mt.match_device(d)
        ids, pos, cnt = reduce.reduce_from_dense(res)
        c = int(cnt)
        p64 = pos.to(torch.int64)
        fingerprint = [c, int((ids.to(torch.int64) * (p64 % 65521)).sum())]
        run = lambda: reduce.reduce_from_dense(res)
        emit(what="reduce", corpus=name, npad=res.shape[0], matches=c,
             ms=ab._ms(run, batch=10), device_ms=ab._kernels(run),
             bound_ms=12 * res.shape[0] / HBM * 1e3,
             nonzero_ms=ab._ms(lambda: torch.nonzero(res > 0), batch=10),
             fingerprint=fingerprint, clocks=ab._clocks())
        eng = mt._engine()
        if name in ("random", "defcon_like", "mixed"):
            n = d.shape[0]
            _, bits, counts = sieve.sieve(d, n, npad_for(n), eng._sieve)
            thresh = eng.tile_rows * 128 // block_walk.DENSE_ESCAPE_DIV
            fn = lambda: compact.compact(bits, counts, thresh)
            emit(what="compact", corpus=name, device_ms=ab._kernels(fn, 10))
            del bits, counts
        del d, res, ids, pos, p64
        torch.cuda.empty_cache()
    forced = list(gathers.PLACEMENTS)
    for name, table, idx in _gather_cases(dev):
        take_idx = idx.long()
        emit(what="G1", case=name, placement="torch.take",
             device_ms=ab._kernels(lambda: torch.take(table, take_idx)))
        default = getattr(gathers, "word_placement", None)
        order = forced + forced[::-1] + ([None] if default else [])
        for p in order:
            if p == "smem" and table.numel() > gathers.SMEM_WORDS:
                continue
            fn = lambda: gathers.word_gather(table, idx, p)
            assert torch.equal(fn(), table[take_idx])
            emit(what="G1", case=name,
                 placement=p or f"default ({default(table.numel())})",
                 ms=ab._ms(fn, batch=10), device_ms=ab._kernels(fn, 10),
                 bound_ms=(8 * idx.numel() + 4 * table.numel()) / HBM * 1e3)
    return 0


def main(argv: list[str]) -> int:
    if len(argv) >= 2 and argv[0] == "--worker":
        return worker(argv[1])
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--worker", tree]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Same-card A/B of the device reduce and of G1 between checkouts, on
seeded synthetic inputs (no ruleset to build, so a turn takes seconds):

    python -m pfac_tpu_torch.experiments.variant_ab --reduce DIR [DIR ...]
    python -m pfac_tpu_torch.experiments.variant_ab --g1 DIR [DIR ...]

One worker process per DIR, in the order given (``a b b a`` runs two trees
in turns), importing ``pfac_tpu_torch`` from DIR. ``--reduce`` times
``reduce.reduce_from_dense`` on results made on the card from a seeded
generator: 128 Mi positions with 3.2%, 7.7% and 0.0033% of them matching
(like random, defcon_like and big_ruleset), 100 Mi all and none matching
(all_match, no_match), 16 Mi with 3% and every 16th 64K block dense
(mixed) and 4 Mi with 2% (f1_entry_tables). ``--g1`` times
``gathers.word_gather`` on random tables of 1.15 to 600 times one CTA's
shared memory, in the placements ``prefix`` and ``ldg`` in turns (and
every placement the tree has but ``smem`` on E2's size; a tree without
``prefix`` runs the others). Each line: the CUDA-event
median over batches of 10 calls, the profiler's device ms by kernel, the
bound, and whether the result equals the plain version. Without CUDA it
exits 1.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
HBM = 3.35e12              # H100 SXM device memory, bytes/s (data sheet)


def _match_ab():
    spec = importlib.util.spec_from_file_location(
        "_ab_match_ab", os.path.join(HERE, "match_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _results(dev):
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(1)
    for name, n, share in (("3.2%", 128 << 20, 0.032),
                           ("7.7%", 128 << 20, 0.077),
                           ("0.0033%", 128 << 20, 3.3e-5),
                           ("all", 100 << 20, 1.0), ("none", 100 << 20, 0.0),
                           ("3% + dense blocks", 16 << 20, 0.03),
                           ("2%", 4 << 20, 0.02)):
        hit = torch.rand(n, generator=g, device=dev) < share
        val = torch.randint(1, 1 << 20, (n,), generator=g, device=dev,
                            dtype=torch.int32)
        r = torch.where(hit, val, torch.zeros_like(val))
        if name == "3% + dense blocks":
            r.view(-1, 65536)[::16] = val.view(-1, 65536)[::16]
        yield name, r


def _reduce(tree: str, ab, dev) -> None:
    import torch
    from pfac_tpu_torch.backends import reduce

    for name, r in _results(dev):
        ok = all(torch.equal(a, b) for a, b in
                 zip(reduce.reduce_from_dense(r), reduce.reduce_plain(r)))
        run = lambda: reduce.reduce_from_dense(r)
        print(json.dumps({"tree": tree, "case": name, "ok": ok,
                          "ms": ab._ms(run, batch=10),
                          "device_ms": ab._kernels(run, 10),
                          "bound_ms": 12 * r.numel() / HBM * 1e3}),
              flush=True)


def _g1(tree: str, ab, dev) -> None:
    import numpy as np
    import torch
    from pfac_tpu_torch.experiments import gathers

    rng = np.random.default_rng(0)
    for words, n in ((66560, 4 << 20), (65208, 16 << 20), (82176, 16 << 20),
                     (116225, 16 << 20), (174336, 16 << 20),
                     (232448, 16 << 20), (464896, 16 << 20),
                     (39874176, 16 << 20)):
        table = torch.from_numpy(rng.integers(0, 1 << 20, size=words)
                                 .astype(np.int32)).to(dev)
        idx = torch.from_numpy(rng.integers(0, words, size=n)
                               .astype(np.int32)).to(dev)
        want = table[idx.long()]
        arms = [p for p in (gathers.PLACEMENTS[1:] if words == 66560
                            else ("prefix", "ldg"))
                if p in gathers.PLACEMENTS]       # the parent has no prefix
        for p in (*arms, *arms[::-1]):
            fn = lambda: gathers.word_gather(table, idx, p)
            print(json.dumps({"tree": tree, "words": words, "lookups": n,
                              "placement": p, "ok": torch.equal(fn(), want),
                              "ms": ab._ms(fn, batch=10),
                              "device_ms": ab._kernels(fn, 10),
                              "bound_ms": (8 * n + 4 * words) / HBM * 1e3}),
                  flush=True)


def worker(what: str, tree: str) -> int:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import pfac_tpu_torch as pt

    if not torch.cuda.is_available():
        print("no GPU (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    assert os.path.abspath(pt.__file__).startswith(os.path.abspath(tree))
    (_reduce if what == "--reduce" else _g1)(tree, _match_ab(),
                                             torch.device("cuda:0"))
    return 0


def main(argv: list[str]) -> int:
    if len(argv) >= 3 and argv[0] == "--worker":
        return worker(argv[1], argv[2])
    if len(argv) < 2 or argv[0] not in ("--reduce", "--g1"):
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv[1:]:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--worker", argv[0], tree]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Entry points of the port that a harness calls; counterpart of the
repo's ``__graft_entry__.py``.

* :func:`entry` -> ``(fn, example_args)``: one forward step of the lockstep
  walker (``backends/xla.py``: the dense table, the fused pair tables, a
  sentinel-padded input, :func:`~pfac_tpu_torch.backends.xla.walk_tiles`)
  over the reference's example automaton (64 patterns of 2-11 printable
  bytes, ``default_rng(7)``) and 8,192 random bytes (``default_rng(0)``),
  the arguments on the device.
* :func:`dryrun_multichip` ``(n)``: one full sharded match over an
  n-shard mesh (``dist/sharding.py``; halo written into each shard, the
  count summed), with both engines (the lockstep walker, ``"xla"``, and
  the sieve pipeline, ``"sieve"``) and a pattern planted across every
  shard boundary; ``match`` and ``match_count`` against
  ``golden.match_dense``.

Run:  python -m pfac_tpu_torch.tools.graft_entry [--device cpu]
Runs ``entry`` and ``dryrun_multichip(8)`` and prints a line each. On the
card by default (the 8 shards dealt round robin over the visible GPUs);
without a GPU it exits 1 unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

TILE = 2048          # the walker's tile in entry()
ENTRY_BYTES = 8192
SHARD_TILE = 256     # the walker's tile in dryrun_multichip()
SHARDS = 8           # the mesh of main(), as the reference's min(8, devices)


def example_automaton():
    """The reference's example rule set: 64 patterns of 2-11 bytes from
    32-126, ``default_rng(7)``."""
    from ..core.automaton import Automaton

    rng = np.random.default_rng(7)
    pats = [
        bytes(rng.integers(32, 127, size=int(rng.integers(2, 12)))
              .astype(np.uint8))
        for _ in range(64)
    ]
    return Automaton.from_patterns(pats)


def entry(device="cuda"):
    """A forward step of the lockstep walker + its example arguments on
    `device`: ``fn(table_flat, pair_state, pair_match, data_u8)`` ->
    int32[num_tiles * TILE] longest-match IDs."""
    from ..backends.xla import (_pad_len, dense_device_table, dense_step_fn,
                                pair_tables, sentinel_pad, walk_tiles)

    dev = torch.device(device)
    a = example_automaton()
    num_tiles, _ = _pad_len(ENTRY_BYTES, TILE, a.max_pattern_len)

    def fn(table_flat, pair_state, pair_match, data_u8):
        _, padded = _pad_len(data_u8.shape[0], TILE, a.max_pattern_len)
        inp = sentinel_pad(data_u8, padded)
        return walk_tiles(
            dense_step_fn(table_flat), pair_state, pair_match, inp,
            num_final=a.num_final_states, max_len=a.max_pattern_len,
            tile=TILE, num_tiles=num_tiles,
        )

    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=ENTRY_BYTES, dtype=np.uint8)
    ps, pm = pair_tables(a)
    example_args = tuple(
        torch.from_numpy(x).to(dev)
        for x in (dense_device_table(a).reshape(-1), ps, pm, data))
    return fn, example_args


def dryrun_multichip(n_devices: int, devices=None) -> str:
    """One full sharded match over `n_devices` shards, both engines,
    checked against the golden model -> the line it prints. `devices`:
    the shards' devices (a device may repeat; CPU devices only when
    passed); default the visible GPUs, round robin."""
    from ..backends import golden
    from ..dist.sharding import ShardedMatcher, device_mesh, make_data_mesh

    mesh = (device_mesh("cuda", n_devices) if devices is None
            else make_data_mesh(n_devices, devices))
    assert mesh.size == n_devices, \
        f"need {n_devices} devices, have {mesh.size}"
    a = example_automaton()
    sm = ShardedMatcher(a, mesh=mesh, tile=SHARD_TILE, engine="xla")

    rng = np.random.default_rng(1)
    shard_len = SHARD_TILE * 2
    n = n_devices * shard_len + 37      # 2 tiles a shard + a ragged tail
    buf = rng.integers(0, 256, size=n, dtype=np.uint8)
    # a pattern across every shard boundary, so that the halo is used
    pat = a.sorted_patterns[len(a.sorted_patterns) // 2]
    for b in range(shard_len, n - len(pat), shard_len):
        start = b - len(pat) // 2
        buf[start:start + len(pat)] = np.frombuffer(pat, dtype=np.uint8)
    data = buf.tobytes()

    result = sm.match(data)
    count = sm.match_count(data)
    expected = golden.match_dense(a, data)
    assert result.shape[0] == n
    assert np.array_equal(result, expected), "sharded result != golden"
    assert count == int((expected > 0).sum())

    sm2 = ShardedMatcher(a, mesh=mesh, engine="sieve")
    assert np.array_equal(sm2.match(data), expected), "sieve shard != golden"
    assert sm2.match_count(data) == count
    line = (f"dryrun_multichip({n_devices}): OK — {count} matches over {n} "
            f"bytes, mesh=({mesh.size} shards on "
            f"{', '.join(sorted({str(d) for d in mesh.devices}))}), "
            f"engines=[xla, sieve]")
    print(line, flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (every visible GPU) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("graft_entry: no GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    fn, example_args = entry(dev)
    out = fn(*example_args)
    print(f"entry(): ran, out shape {tuple(out.shape)}", flush=True)
    dryrun_multichip(SHARDS, None if dev.type == "cuda" else [dev] * SHARDS)
    return 0


if __name__ == "__main__":
    sys.exit(main())

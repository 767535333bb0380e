"""What the gather micro-benchmarks share: a case, its check against the
plain version and the reference's numpy expectation, its CUDA-event timing,
and the modules' ``main``.

A module yields :class:`Case` objects (and :class:`Refusal` objects where a
placement must refuse its table) from functions that take their sizes as
arguments, so the CPU tests run the same cases small: on CPU tensors the
wrappers run their plain versions.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from . import gathers

BATCH = 10      # calls per timed sample: short cases measure launch cost
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory, NVIDIA's data sheet


@dataclasses.dataclass
class Case:
    name: str
    kernel: str                  # a gathers.LAUNCHES key
    lookups: int                 # table reads per call
    run: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    expect: np.ndarray | None    # the reference case's result, from numpy
    bytes: int = 0               # the bound's bytes: inputs once, output once
    library: Callable[[], torch.Tensor] | None = None   # one PyTorch call

    @property
    def bound_ms(self) -> float:
        """The least time the card could take: the bytes the function must
        move over the device memory's peak rate."""
        return self.bytes / HBM_BYTES_PER_S * 1e3


@dataclasses.dataclass
class Refusal:
    name: str
    call: Callable[[], object]   # must raise ValueError


def word_cases(label: str, table: torch.Tensor, idx: torch.Tensor,
               expect: np.ndarray, placements=gathers.PLACEMENTS,
               chain: int | None = None,
               hashed: bool = False) -> Iterator[Case | Refusal]:
    """G1 (or G3, given `chain`) on one table, one case per placement; a
    table too large for shared memory gives a Refusal there."""
    for p in placements:
        name = f"{label} {p}"
        library = None
        if chain is None:
            kernel, lookups = "word_gather_kernel", idx.numel()
            run = (lambda p=p: gathers.word_gather(table, idx, p))
            plain = (lambda: gathers.word_gather_plain(table, idx))
            library = gathers.word_gather_library(table, idx)
        else:
            kernel, lookups = "chain_gather_kernel", idx.numel() * chain
            run = (lambda p=p: gathers.chain_gather(table, idx, chain, p,
                                                    hashed))
            plain = (lambda: gathers.chain_gather_plain(table, idx, chain,
                                                        hashed))
        if p == "smem" and table.numel() > gathers.SMEM_WORDS:
            yield Refusal(name, run)
        else:
            yield Case(name, kernel, lookups, run, plain, expect,
                       8 * idx.numel() + 4 * table.numel(), library)


def tile_case(name: str, tile: torch.Tensor, idx: torch.Tensor, axis: int,
              expect: np.ndarray) -> Case:
    """G2 on one tile along `axis`, with torch.gather as its yardstick."""
    return Case(name, "tile_gather_kernel", idx.numel(),
                lambda: gathers.tile_gather(tile, idx, axis),
                lambda: gathers.tile_gather_plain(tile, idx, axis), expect,
                8 * idx.numel() + 4 * tile.numel(),
                gathers.tile_gather_library(tile, idx, axis))


def check(case: Case) -> int:
    """Run the case once: the kernel's output must equal its plain
    version's and the reference's numpy expectation (tolerance 0).
    -> max |kernel - plain| (0)."""
    out, ref = case.run(), case.plain()
    err = int((out.to(torch.int64) - ref.to(torch.int64)).abs().max()) \
        if out.numel() else 0
    if out.shape != ref.shape or err:
        raise AssertionError(f"{case.name}: kernel != plain (max err {err})")
    got = out.cpu().numpy()
    if case.expect is not None and not np.array_equal(got, case.expect):
        raise AssertionError(f"{case.name}: != the reference's expectation")
    return err


def refuse(r: Refusal) -> str:
    try:
        r.call()
    except ValueError as e:
        return f"{r.name}: refused ({e})"
    raise AssertionError(f"{r.name}: not refused")


def measure(case: Case, label: str) -> dict:
    """CUDA-event medians of the case, its plain version and its library
    call, each over batches of BATCH calls; prints one line. Call check()
    first."""
    plain_ms = gathers.cuda_ms(case.plain, reps=5, warmup=1, batch=BATCH)
    ms = gathers.cuda_ms(case.run, batch=BATCH)
    library_ms = (None if case.library is None else
                  gathers.cuda_ms(case.library, batch=BATCH))
    lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
    print(f"time {case.name}: {ms:.4f} ms, {case.lookups / ms / 1e6:.2f} G "
          f"lookups/s, plain {plain_ms:.4f} ms{lib}, bound "
          f"{case.bound_ms:.4f} ms, equal=True ({case.kernel})  [{label}]",
          flush=True)
    return {"name": case.name, "kernel": case.kernel, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": case.bound_ms, "lookups": case.lookups}


def _smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return _smi("name,power.limit")


def clocks() -> str:
    """The SM clock, its maximum, power draw and temperature now."""
    return _smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")


def main(make: Callable[[torch.device], Iterable[Case | Refusal]]) -> int:
    """A module's entry point: every case on the card, checked and timed.
    No CPU path: without CUDA it returns 1."""
    if not torch.cuda.is_available():
        print("no GPU (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    from .. import _build

    label = card()
    print(label)
    _build.load()
    for item in make(torch.device("cuda:0")):
        if isinstance(item, Refusal):
            print(refuse(item), flush=True)
        else:
            check(item)
            item.expect = None
            measure(item, label)
    return 0

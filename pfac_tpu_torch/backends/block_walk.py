"""Dense-block escape: kernel K3 and its plain torch versions.

K3 (``block_walk_kernel`` in ``csrc/block_walk.cu``) replaces the Pallas
block-walk kernel ``pfac_tpu.backends.pallas_sieve.build_block_walk``. A
block of ``block`` positions is dense when the sieve counted at least
``block // DENSE_ESCAPE_DIV`` survivors in it (``DENSE_ESCAPE_DIV = 4``, as
the reference's ``pallas_sieve.DENSE_ESCAPE_DIV``). Every position of a
dense block is walked to full depth as K2 walks a survivor and its matches
of >= 4 bytes written into the sieve's result in place. The compaction
(``compact.py``) reads the same counts and threshold and leaves the block
out, so K2 never sees its positions. The sieve already wrote the exact
depth-1..3 match at every position, so the block's result is then
complete, as the reference's K3 writes it.

The kernel reads the counts on the device: a persistent grid numbers the
dense blocks' tiles of ``CHUNK`` positions and each CTA takes its share, so
the escape needs no host round trip and a corpus without dense blocks pays
one pass of the grid over the counts. A tile is walked from shared memory:
its ``CHUNK`` bytes and :func:`lookahead` more arrive by an asynchronous
bulk copy, and the walk tables (as K2 reads them, ``walk_tables.pack_walk``)
are resident there by depth, as far as
:func:`resident_words` finds room (down to none: a ruleset whose entry
tables outgrow the room is walked from L1/L2 whole); deeper tables are read
through L1/L2.
The reference batches 64 blocks per launch to save XLA dispatch; one launch
covers every block here.

:func:`block_walk_plain` walks the dense blocks' positions over the whole
corpus; :func:`block_walk_tiles_plain` does what the kernel does, tile by
tile, each from its own slice of ``CHUNK + lookahead`` bytes. Through a
program K3 counts its probes and the positions it walked on the card
(``trace``'s ``block_walk_probes`` and ``block_walk_positions``), and
:func:`block_walk_probes_plain` recounts the probes on the host; the
wrapper :func:`block_walk` counts nothing.
"""
from __future__ import annotations

import torch

from .. import _build, trace
from .probe import DESC_WORDS, Packed
from .sieve import SMEM_LIMIT
# K3 keeps K2's residency rule: the same tables, the same prefix
from .walk import (alive_trail_plain, resident_words,  # noqa: F401
                   steps_of, table_ends, walk_plain)

DENSE_ESCAPE_DIV = 4        # as pfac_tpu.backends.pallas_sieve
CHUNK = 8192                # positions per tile; block % CHUNK == 0
_PLAIN_CHUNK = 1 << 22      # positions per walk_plain call
_PROBE_CHUNK = 1 << 18      # positions per call of the probes' recount
_BATCH = 8                  # positions probed together, as csrc/block_walk.cu
_WARPS = 16                 # as csrc/block_walk.cu
_HEADER, _TILE_PAD, _WARP_STAGE = 32, 32, 4 * 512


def lookahead(nsteps: int) -> int:
    """Bytes past a tile's last position that its walks may read: the entry
    key's 4 and 2 a step, rounded up to the bulk copy's 16."""
    return -(-(4 + 2 * nsteps) // 16) * 16


def tile_cap(ntiles: int, sms: int) -> int:
    """Room for the tile numbers one CTA of the persistent grid (>= one CTA
    per SM) may have to keep, a multiple of 4 words."""
    per_cta = -(-ntiles // sms)
    return max(4, -(-per_cta // 4) * 4)


def fixed_smem_bytes(nsteps: int, cap: int) -> int:
    """K3's dynamic shared memory without the resident tables
    (csrc/block_walk.cu): barriers, two tile buffers, the warps' store
    staging, the descriptor rows and the CTA's tile numbers."""
    tile = CHUNK + lookahead(nsteps) + _TILE_PAD
    return (_HEADER + 2 * tile + _WARPS * _WARP_STAGE
            + 4 * DESC_WORDS * (2 + 3 * nsteps) + 4 * cap)


def _check(data, n, counts, match, tabs: Packed) -> int:
    if data.dtype != torch.uint8 or data.dim() != 1 or not data.is_contiguous():
        raise ValueError("data must be a contiguous 1-D uint8 tensor")
    npad = match.shape[0]
    if (counts.dtype != torch.int32 or match.dtype != torch.int32
            or counts.shape[0] == 0 or npad % counts.shape[0]
            or not (match.is_contiguous() and counts.is_contiguous())):
        raise ValueError("need int32 counts[nblocks] and int32 match[npad], "
                         "contiguous, nblocks | npad")
    if not 0 <= n <= min(data.shape[0], npad):
        raise ValueError("need n <= len(data) and n <= npad")
    for t in (counts, match, tabs.arena, tabs.desc):
        if t.device != data.device:
            raise ValueError("all tensors must be on the data's device")
    return npad // counts.shape[0]


def block_walk(data: torch.Tensor, n: int, counts: torch.Tensor,
               match: torch.Tensor, tabs: Packed) -> None:
    """Walk every position of each dense block into `match` in place. A CPU
    tensor runs the plain version; a CUDA tensor launches K3."""
    block = _check(data, n, counts, match, tabs)
    if data.device.type == "cpu":
        return block_walk_plain(data, n, counts, match, tabs)
    if data.device.type != "cuda":
        raise ValueError(f"no block walk for device {data.device}")
    if block % CHUNK:
        raise ValueError(f"the block must be a multiple of {CHUNK} positions")
    nsteps, look, cap, resident = launch_plan(tabs, match.shape[0] // CHUNK,
                                              data.device)
    rc = _build.load().pfac_block_walk(
        data.device.index or 0, data.data_ptr(), n, counts.data_ptr(),
        counts.shape[0], block, block // DENSE_ESCAPE_DIV,
        tabs.arena.data_ptr(), tabs.arena.numel(), resident,
        tabs.desc.data_ptr(), nsteps, look, cap, match.data_ptr(),
        torch.cuda.current_stream(data.device).cuda_stream)
    trace.count("launch.block_walk_kernel")
    _build.check(rc, "block_walk_kernel")
    return None


def launch_plan(tabs: Packed, ntiles: int,
                device: torch.device) -> tuple[int, int, int, int]:
    """(nsteps, lookahead, tile-number room, resident table words) of a K3
    launch over `ntiles` tiles on a CUDA device; kept with the tables. The
    resident words may be 0: every plan fits."""
    key = ("k3_plan", ntiles, device.index)
    plan = tabs.derived.get(key)
    if plan is None:
        nsteps = steps_of(tabs)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        cap = tile_cap(ntiles, sms)
        plan = tabs.derived[key] = (
            nsteps, lookahead(nsteps), cap,
            resident_words(tabs, SMEM_LIMIT - fixed_smem_bytes(nsteps, cap)))
    return plan


def _dense(counts: torch.Tensor, block: int) -> torch.Tensor:
    return torch.nonzero(counts >= block // DENSE_ESCAPE_DIV).reshape(-1)


def block_walk_plain(data: torch.Tensor, n: int, counts: torch.Tensor,
                     match: torch.Tensor, tabs: Packed) -> None:
    """Plain torch version of K3, on the data's device."""
    block = match.shape[0] // counts.shape[0]
    dense = _dense(counts, block)
    if dense.numel() == 0:
        return None
    pos = (dense[:, None] * block
           + torch.arange(block, device=data.device)).reshape(-1)
    pos = pos[pos < n].to(torch.int32)
    for c0 in range(0, pos.shape[0], _PLAIN_CHUNK):
        walk_plain(data, n, pos[c0:c0 + _PLAIN_CHUNK], match, tabs)
    return None


def dense_tiles(n: int, counts: torch.Tensor, block: int) -> list[int]:
    """First positions of the tiles K3 walks: every CHUNK of a dense block
    that starts below n."""
    return [c0 for b in _dense(counts, block).tolist()
            for c0 in range(b * block, (b + 1) * block, CHUNK) if c0 < n]


def block_walk_tiles_plain(data: torch.Tensor, n: int, counts: torch.Tensor,
                           match: torch.Tensor, tabs: Packed) -> None:
    """K3 as the kernel sees the corpus: each dense tile is walked alone,
    from a slice of its CHUNK bytes and lookahead(nsteps) more, bytes at
    and past n as 0, and its matches of >= 4 bytes land in `match`."""
    block = match.shape[0] // counts.shape[0]
    size = CHUNK + lookahead(steps_of(tabs))
    for c0 in dense_tiles(n, counts, block):
        have = min(size, n - c0)
        tile = torch.zeros(size, dtype=torch.uint8, device=data.device)
        tile[:have] = data[c0:c0 + have]
        pos = torch.arange(min(CHUNK, have), dtype=torch.int32,
                           device=data.device)
        out = torch.zeros(CHUNK, dtype=torch.int32, device=data.device)
        walk_plain(tile, have, pos, out, tabs)
        deep = out > 0
        match[c0:c0 + CHUNK][deep] = out[deep]
    return None


def escaped_blocks(counts: torch.Tensor, npad: int) -> int:
    """How many blocks the escape walks for these sieve counts."""
    block = npad // counts.shape[0]
    return int((counts >= block // DENSE_ESCAPE_DIV).sum())


def block_walk_probes_plain(data: torch.Tensor, n: int, counts: torch.Tensor,
                            tabs: Packed, block: int) -> int:
    """The ``block_walk_probes`` a program's K3 adds for one call: the
    exact-table probes of every position of the tiles it walks (those at
    and past n too), dealt as ``csrc/block_walk.cu`` deals them. A batch of
    8 consecutive positions probes the entry table (where the walk has
    steps) and entry_final (where present), 8 probes each; then each step's
    odd, main and even tables, those present, 8 probes each, while two or
    more of the batch are alive, the step whose main table is absent ending
    after its odd probes; the one left alive then walks on alone, a probe a
    present table a step, as long as its walk lasts."""
    nsteps = steps_of(tabs)
    on = [int(row[6] != 0) for row in tabs.rows]
    odd, main, even = (torch.tensor([0] + on[k::3][:nsteps], dtype=torch.int64)
                       for k in (3, 2, 4))
    # G[s], F[s]: a lone walk's and a batch's probes over steps 0 .. s - 1
    g = torch.cumsum(odd + main + even, 0)
    f = _BATCH * g
    absent = [s for s in range(nsteps) if not on[2 + 3 * s]]
    stop = absent[0] if absent else None     # no deeper state exists
    per_batch = _BATCH * ((nsteps > 0) + on[1])
    tiles = dense_tiles(n, counts, block)
    total = 0
    per = _PROBE_CHUNK // CHUNK
    for i in range(0, len(tiles), per):
        c0 = torch.tensor(tiles[i:i + per], dtype=torch.int64,
                          device=data.device)
        pos = (c0[:, None] + torch.arange(CHUNK, device=data.device)
               ).reshape(-1)
        trail = alive_trail_plain(data, n, pos, tabs)
        batches = pos.numel() // _BATCH
        total += per_batch * batches
        if not trail:
            continue
        alive = torch.stack(trail).reshape(len(trail), batches, _BATCH).cpu()
        # a position never comes back to life, so the batch's alive count
        # falls step by step: it steps batched for k steps, and its longest
        # walk lasts the steps its last one alive was alive
        k = (alive.sum(-1) >= 2).sum(0)
        last = alive.sum(0).max(-1).values
        if stop is not None and bool((k > stop).any()):
            reached = k > stop
            total += int(reached.sum()) * int(
                f[stop] + _BATCH * odd[stop + 1])
            k, last = k[~reached], last[~reached]
        total += int(f[k].sum()) + int((g[torch.maximum(last, k)]
                                        - g[k]).sum())
    return total

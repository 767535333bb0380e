"""Lockstep walker: counterpart of ``pfac_tpu.backends.xla``.

The engine for every call the reference sends to its ``XlaMatcher``:
``Backend.XLA``, ``Platform.CPU_PARALLEL`` (the same engine on
``torch.device("cpu")``), ``PlacementMode.HBM``, and the fallback when the
sieve engine's host tables cannot be built (``select.try_build``). It walks
a failureless automaton from every start position. The reference compiles
the walk into one device program a call; on a CUDA device the port makes
it one launch of a hand-written kernel (``lockstep.py``,
``csrc/lockstep.cu``: the two-byte stage from the pair states, in shared
memory where their compacted form fits, then the longer walks packed onto
busy lanes; reading the uint8 input and its length directly), with no host
synchronisation and no padded copy. On the CPU it walks in torch
(:func:`walk_tiles`, the kernel's plain version). The reference's names
are kept, so each function has its counterpart:

* **trap = state 0**: device row 0 is all zero and every trap edge points
  at 0, so a trapped lane stays at 0 and keeps its match;
* **sentinel column 256**: the torch walk pads the input with the value
  256, whose column is all-trap, so walks die at the end of the input with
  no bounds check (the input is int16: the sentinel does not fit a byte);
  the kernel treats a byte at or past n the same way;
* **fused first two steps**: one gather from the 257 x 257 pair tables
  gives the state and the best match after two bytes;
* **early exit**: the reference's ``while_loop`` stops a tile when every
  lane has trapped, a test on the device. The kernel's threads each stop
  on their own. :func:`walk_tiles` walks pieces of up to :data:`PIECE`
  positions, keeps only the live lanes after the pair step, and compacts
  them again every :data:`COMPACT_EVERY` steps (a host test each time). A
  trapped lane keeps its match, so the result does not depend on when the
  loop stops.

Table indices are int64 (``state * 257 + ch`` passes int32 past 8.36 M
dense rows). A 100K-signature ruleset takes dense mode (6.2 GB of table on
the card): its hash tables cannot be built in either package, because its
initial state has 256 transitions and the hash tables' slot schedule stops
at 255 (``core/tables._bin_size``). The reduce is the port's device reduce
(``reduce.py``), shared with the sieve engine.

Left behind (ROADMAP.md, "Leave behind"): ``_reduce_scatter_max`` (the
quarantined scatter arm) and the TPU's MXU prefix sums ``_prefix_mat``,
``_lane_prefix``, ``_prefix_1d`` and ``_rank_rows``; ``_reduce_padded`` and
``_reduce_rowgather`` are ``reduce.reduce_from_dense``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.automaton import Automaton
from ..core.tables import HASH_KEY_K_MASKBITS, HASH_KEY_S_MASK
from ..core.trie import CHAR_SET, TRAP_STATE
from ..status import PfacError, PfacStatus
from .golden import _as_u8
from .lockstep import lockstep_walk, pair_form, placement_for
from .reduce import reduce_from_dense

SENTINEL = CHAR_SET    # 256: the padding value; column 256 is all-trap
STRIDE = CHAR_SET + 1  # 257 columns in device tables
DEFAULT_TILE = 1 << 17  # 128K start positions per tile (the output's grain)
PIECE = 1 << 24        # start positions walked together
COMPACT_EVERY = 8      # steps between compactions of the live lanes


# --------------------------------------------------------------------------
# Device table preparation (host side, numpy; uploaded once per automaton)
# --------------------------------------------------------------------------

def dense_device_table(automaton: Automaton) -> np.ndarray:
    """Dense device table int32[S, 257]: trap -> 0, row 0 = 0, col 256 = 0,
    built from the trie's edge list over a zeroed array."""
    if automaton.trie is not None:
        e = automaton.trie.edges_array()
        dev = np.zeros((automaton.num_states, STRIDE), dtype=np.int32)
        if e.size:
            dev[e[:, 0], e[:, 1]] = e[:, 2]
        dev[0, :] = 0
        return dev
    src = automaton.ensure_dense().table  # [S, 256], trap = -1
    s = src.shape[0]
    dev = np.zeros((s, STRIDE), dtype=np.int32)
    dev[:, :CHAR_SET] = np.where(src == TRAP_STATE, 0, src)
    dev[0, :] = 0
    return dev


def _device_rows(automaton: Automaton, states: np.ndarray) -> np.ndarray:
    """Rows `states` of :func:`dense_device_table`, without building the
    whole table (int32[len(states), 257])."""
    if automaton.trie is None:
        return dense_device_table(automaton)[states]
    e = automaton.trie.edges_array()
    at = np.full(automaton.num_states, -1, dtype=np.int64)
    at[states] = np.arange(len(states))
    out = np.zeros((len(states), STRIDE), dtype=np.int32)
    if e.size:
        sel = at[e[:, 0]] >= 0
        out[at[e[sel, 0]], e[sel, 1]] = e[sel, 2]
    out[np.asarray(states) == 0] = 0
    return out


def pair_tables(automaton: Automaton) -> tuple[np.ndarray, np.ndarray]:
    """Fused two-byte tables, each int32[257*257] flat: pair_state[c1*257 +
    c2] is the device state after (c1, c2) from the initial state,
    pair_match[...] the best match within those two bytes; 256 is past the
    end of the input. Built from the rows of the initial state and its
    children only (the reference builds the whole dense table)."""
    k = automaton.num_final_states
    init = automaton.initial_state

    row = _device_rows(automaton, np.array([init]))[0]
    c1 = np.arange(STRIDE, dtype=np.int64)
    s1 = np.where(c1 < CHAR_SET, row[np.minimum(c1, CHAR_SET - 1)], 0)
    s1[SENTINEL] = 0
    m1 = np.where((s1 >= 1) & (s1 <= k), s1, 0)

    states, inv = np.unique(s1, return_inverse=True)
    s2 = _device_rows(automaton, states)[inv]  # [257, 257]
    m2 = np.where((s2 >= 1) & (s2 <= k), s2, m1[:, None])
    return (
        s2.astype(np.int32).reshape(-1),
        m2.astype(np.int32).reshape(-1),
    )


def hash_device_tables(automaton: Automaton) -> dict[str, np.ndarray]:
    """Hashed device tables with the same trap = 0 renumbering. Empty rows
    (and state 0) probe a poison slot at index E whose stored char (-1)
    never equals an input value, so the probe's verify yields 0."""
    ht = automaton.ensure_hash()
    e = ht.val.shape[0]

    rp_off = ht.row_ptr[:, 0].astype(np.int32).copy()
    rp_key = ht.row_ptr[:, 1].astype(np.int32).copy()
    empty = rp_off < 0
    rp_off[empty] = e
    rp_key[empty] = 0  # k = 0, s-1 = 0 -> always probes the poison slot
    rp_off[0] = e      # state 0 (device trap) self-traps
    rp_key[0] = 0

    val_next = np.zeros(e + 1, dtype=np.int32)
    val_ch = np.full(e + 1, -1, dtype=np.int32)
    val_next[:e] = np.where(ht.val[:, 0] == TRAP_STATE, 0, ht.val[:, 0])
    val_ch[:e] = ht.val[:, 1]
    return {
        "rp_off": rp_off,
        "rp_key": rp_key,
        "val_next": val_next,
        "val_ch": val_ch,
    }


# --------------------------------------------------------------------------
# The walk
# --------------------------------------------------------------------------

def _pad_len(n: int, tile: int, max_len: int) -> tuple[int, int]:
    num_tiles = max(1, -(-n // tile))
    return num_tiles, num_tiles * tile + max(max_len, 2)


def dense_step_fn(table_flat: torch.Tensor):
    """One automaton step for a vector of lanes, dense encoding."""

    def step(state: torch.Tensor, ch: torch.Tensor) -> torch.Tensor:
        return torch.take(table_flat, state.long() * STRIDE + ch)

    return step


def hash_step_fn(rp_off, rp_key, val_next, val_ch):
    """One automaton step by the modulo-free perfect-hash probe, on int32
    (``>>`` is arithmetic, as in jnp)."""

    def step(state: torch.Tensor, ch: torch.Tensor) -> torch.Tensor:
        s = state.long()
        off_row = torch.take(rp_off, s)
        key = torch.take(rp_key, s)
        ch = ch.to(torch.int32)
        # modulo-free (k*ch) mod 257: x = 256q + r  ==>  r - q (mod 257)
        x = (key >> HASH_KEY_K_MASKBITS) * ch
        beta = (x & 0xFF) - (x >> 8)
        beta = torch.where(beta < 0, beta + 257, beta)
        slot = (off_row + (beta & (key & HASH_KEY_S_MASK))).long()
        nxt = torch.take(val_next, slot)
        stored = torch.take(val_ch, slot)
        return torch.where(stored == ch, nxt, 0)

    return step


def walk_tiles(step, pair_state: torch.Tensor, pair_match: torch.Tensor,
               inp: torch.Tensor, *, num_final: int, max_len: int, tile: int,
               num_tiles: int) -> torch.Tensor:
    """Failureless walks from every position of a sentinel-padded int16
    input -> int32[num_tiles * tile]. The caller guarantees
    ``inp[j] == SENTINEL`` for every j past the true end of the data.

    Each piece of up to PIECE positions takes the pair gather at every
    position, then walks only its live lanes from depth 2 while ``d <
    max_len``, dropping the trapped ones every COMPACT_EVERY steps (the
    host learns the live count there, once per compaction)."""
    total = num_tiles * tile
    out = torch.empty(total, dtype=torch.int32, device=inp.device)
    for off in range(0, total, PIECE):
        width = min(PIECE, total - off)
        c1 = inp[off: off + width].long()
        c2 = inp[off + 1: off + 1 + width].long()
        pair = c1 * STRIDE + c2
        del c1, c2
        state = torch.take(pair_state, pair)
        match = out[off: off + width]
        torch.take(pair_match, pair, out=match)
        del pair
        if max_len <= 2:
            continue
        lane = torch.nonzero(state > 0).reshape(-1)   # live lanes
        s, m = state[lane], match[lane]
        del state
        d = 2
        while d < max_len and lane.numel():
            for _ in range(min(COMPACT_EVERY, max_len - d)):
                s = step(s, inp[lane + (off + d)])
                m = torch.where((s > 0) & (s <= num_final), s, m)
                d += 1
            match[lane] = m
            keep = s > 0
            lane, s, m = lane[keep], s[keep], m[keep]
    return out


def sentinel_pad(data_u8: torch.Tensor, padded: int) -> torch.Tensor:
    """uint8[N] -> int16[padded] with SENTINEL past position N."""
    inp = torch.full((padded,), SENTINEL, dtype=torch.int16,
                     device=data_u8.device)
    inp[: data_u8.shape[0]] = data_u8
    return inp


# --------------------------------------------------------------------------
# Host-facing wrapper
# --------------------------------------------------------------------------

@dataclasses.dataclass
class XlaMatcher:
    """Holds the device tables and walks every start position. On the card
    unless `device` says otherwise: ``"cuda"`` is the current GPU, and with
    no GPU visible it raises. `placement` is where the kernel reads the
    pair states (``lockstep.placement_for``: ``"smem"`` where their
    compacted form fits, else ``"global"``)."""

    automaton: Automaton
    perf_mode: str = "dense"      # "dense" | "hash"
    tile: int = DEFAULT_TILE
    device: torch.device | str = "cuda"

    def __post_init__(self):
        dev = torch.device(self.device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise PfacError(PfacStatus.INVALID_PARAMETER,
                                "no GPU is visible: pass device='cpu'")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        put = lambda x: torch.from_numpy(x).to(dev)
        ps, pm = pair_tables(self.automaton)
        if self.perf_mode == "dense":
            steps = [dense_device_table(self.automaton).reshape(-1)]
        elif self.perf_mode == "hash":
            t = hash_device_tables(self.automaton)
            steps = [t[k] for k in ("rp_off", "rp_key", "val_next", "val_ch")]
        else:
            raise ValueError(f"unknown perf_mode {self.perf_mode!r}")
        #: lockstep_walk's tables: the pair tables, then the step's
        self._tables = tuple(put(x) for x in (ps, pm, *steps))
        form = pair_form(ps)
        self.placement = placement_for(form)
        #: the compacted pair states, kept on the device where the kernel
        #: reads them from shared memory
        self._pairs = put(form) if self.placement == "smem" else None
        self.table_bytes = sum(4 * t.numel() for t in self._tables)

    def match_device(self, data_u8: torch.Tensor) -> torch.Tensor:
        """uint8[N] on this device -> int32[num_tiles * tile] match IDs; the
        padded tail reports 0. On a CUDA device one kernel launch."""
        if data_u8.device != self.device:
            raise PfacError(PfacStatus.INVALID_PARAMETER,
                            f"data is on {data_u8.device}, matcher on "
                            f"{self.device}")
        if data_u8.dtype != torch.uint8 or data_u8.dim() != 1:
            raise PfacError(PfacStatus.INVALID_PARAMETER,
                            "data must be a 1-D uint8 tensor")
        n = int(data_u8.shape[0])
        num_tiles, _ = _pad_len(n, self.tile, self.automaton.max_pattern_len)
        return self._walk(data_u8.contiguous(), n, num_tiles)

    def _walk(self, buf: torch.Tensor, n_valid: int,
              num_tiles: int) -> torch.Tensor:
        """The walk from each of the first ``num_tiles * tile`` positions
        of the uint8 `buf` on this device, over its first `n_valid` bytes
        (the sentinel past them), with this matcher's tables."""
        a = self.automaton
        out = torch.empty(num_tiles * self.tile, dtype=torch.int32,
                          device=buf.device)
        return lockstep_walk(buf, n_valid, out, self._tables,
                             perf_mode=self.perf_mode,
                             num_final=a.num_final_states,
                             max_len=a.max_pattern_len, pairs=self._pairs)

    def match(self, data) -> np.ndarray:
        """bytes in, int32[N] out (PFAC_matchFromHost analog)."""
        arr = _as_u8(data)
        n = arr.shape[0]
        if n == 0:
            return np.zeros(0, dtype=np.int32)
        dev = torch.from_numpy(arr.copy()).to(self.device)
        return self.match_device(dev)[:n].cpu().numpy()

    def match_reduce_device(self, data_u8: torch.Tensor):
        """-> (ids, positions, count) on the device (``reduce.py``)."""
        return reduce_from_dense(self.match_device(data_u8))

    def match_reduce(self, data) -> tuple[np.ndarray, np.ndarray, int]:
        return host_reduce(self.match(data))


def host_reduce(match: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Compacted (ids, positions, count) from a dense host match vector."""
    pos = np.flatnonzero(match > 0).astype(np.int32)
    return match[pos].astype(np.int32), pos, int(pos.shape[0])

"""A plain failureless Aho-Corasick (PFAC) matcher, the benchmark's
reference.

Semantics, as the PFAC library defines them: pattern IDs are 1-based in the
order the patterns are given; for every start position ``i`` of the input,
``result[i]`` is the ID of the longest pattern that starts at ``i``, else 0;
of identical patterns the later ID wins. The reduce form lists the nonzero
positions in ascending order with their IDs.

The trie is built in numpy from the sorted patterns: a node is a prefix,
numbered by where the first sorted pattern that has it spells it in the
patterns' concatenation, so no per-byte Python loop runs. The walk is plain
torch on any device: every start position steps from the root in lockstep,
one byte a step, through a sorted key array (``parent * 256 + byte``)
searched with ``torch.searchsorted``; positions whose walk has ended drop
out of the step. Blocks of start positions bound the memory it takes.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class Trie:
    """The failureless automaton of a pattern list.

    ``root[b]``: the node the root reaches on byte ``b``, -1 if none;
    ``keys`` (sorted) and ``child``: every other edge, ``parent * 256 +
    byte`` -> node; ``out[node]``: the ID of the pattern that ends there, 0
    if none; ``max_len``: the longest pattern."""

    def __init__(self, root: np.ndarray, keys: np.ndarray, child: np.ndarray,
                 out: np.ndarray, max_len: int):
        self.root, self.keys, self.child, self.out = root, keys, child, out
        self.max_len = max_len
        self._on: dict[str, tuple[torch.Tensor, ...]] = {}

    @property
    def nodes(self) -> int:
        """Nodes that exist (the root and one a distinct prefix)."""
        return 1 + int((self.root >= 0).sum()) + int(self.keys.size)

    def tensors(self, device: torch.device) -> tuple[torch.Tensor, ...]:
        """(root, keys, child, out) as torch tensors on `device`, cached."""
        key = str(device)
        if key not in self._on:
            self._on[key] = tuple(torch.from_numpy(a).to(device) for a in (
                self.root, self.keys, self.child, self.out))
        return self._on[key]


def build(patterns: Sequence[bytes]) -> Trie:
    """The trie of `patterns` (non-empty byte strings; IDs 1..k in order)."""
    pats = [bytes(p) for p in patterns]
    if not pats or min(len(p) for p in pats) == 0:
        raise ValueError("need at least one pattern, none of them empty")
    k = len(pats)
    order = sorted(range(k), key=pats.__getitem__)  # stable: equal keep order
    spelled = [pats[i] for i in order]
    ids = np.asarray(order, dtype=np.int64) + 1
    lens = np.fromiter(map(len, spelled), dtype=np.int64, count=k)
    flat = np.frombuffer(b"".join(spelled), dtype=np.uint8)
    total, width = int(lens.sum()), int(lens.max())
    start = np.zeros(k, dtype=np.int64)
    start[1:] = np.cumsum(lens)[:-1]
    row = np.repeat(np.arange(k), lens)
    col = np.arange(total, dtype=np.int64) - start[row]   # depth - 1

    # the common prefix with the previous sorted pattern (256 marks the end)
    lcp = np.zeros(k, dtype=np.int64)
    if k > 1:
        mat = np.full((k, width + 1), 256, dtype=np.int16)
        mat[row, col] = flat
        diff = mat[1:] != mat[:-1]
        first = np.where(diff.any(axis=1), diff.argmax(axis=1), width + 1)
        lcp[1:] = np.minimum(first, np.minimum(lens[1:], lens[:-1]))
        del mat, diff

    # the prefix of depth d of sorted pattern i belongs to the first sorted
    # pattern j <= i that shares it: the last j <= i with lcp[j] < d
    node = np.empty(total, dtype=np.int64)
    every = np.arange(k)
    for d in range(1, width + 1):
        owner = np.maximum.accumulate(np.where(lcp < d, every, -1))
        has = lens >= d
        node[start[has] + d - 1] = start[owner[has]] + d

    created = col >= lcp[row]                 # depth > lcp: a new node
    parent = np.zeros(total, dtype=np.int64)
    inner = col > 0
    parent[inner] = node[np.flatnonzero(inner) - 1]
    top = created & ~inner
    root = np.full(256, -1, dtype=np.int64)
    root[flat[top]] = node[top]
    deep = created & inner
    keys = parent[deep] * 256 + flat[deep]
    child = node[deep]
    sort = np.argsort(keys, kind="stable")
    out = np.zeros(total + 1, dtype=np.int32)
    np.maximum.at(out, node[start + lens - 1], ids.astype(np.int32))
    return Trie(root, keys[sort], child[sort], out, width)


def match_dense(trie: Trie, data: torch.Tensor, n: int | None = None, *,
                max_depth: int | None = None,
                block: int = 1 << 26) -> torch.Tensor:
    """uint8 `data` (any device, at least n bytes; n defaults to all) ->
    int32[n]: the ID of the longest pattern starting at each position.
    `max_depth` stops every walk after that many bytes (the control: a
    matcher that gives up on long patterns)."""
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise ValueError("data must be a 1-D uint8 tensor")
    n = data.numel() if n is None else n
    dev = data.device
    root, keys, child, out = trie.tensors(dev)
    res = torch.zeros(n, dtype=torch.int32, device=dev)
    last = keys.numel() - 1
    for b0 in range(0, n, block):
        b1 = min(n, b0 + block)
        pos = torch.arange(b0, b1, device=dev)
        state = root[data[b0:b1].long()]
        depth = 1
        while True:
            alive = state >= 0
            pos, state = pos[alive], state[alive]
            if pos.numel() == 0:
                break
            ids = out[state]
            hit = ids > 0
            res[pos[hit]] = ids[hit]
            if last < 0 or (max_depth is not None and depth >= max_depth):
                break
            nxt = pos + depth
            inside = nxt < n
            pos, state, nxt = pos[inside], state[inside], nxt[inside]
            key = state * 256 + data[nxt].long()
            at = torch.searchsorted(keys, key).clamp_(max=last)
            state = torch.where(keys[at] == key, child[at],
                                torch.full_like(key, -1))
            depth += 1
    return res


def reduce_form(dense: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                               int]:
    """int32[n] -> (ids, positions, count): the nonzero entries in
    ascending position, both int32."""
    positions = torch.nonzero(dense).flatten()
    return (dense[positions].to(torch.int32), positions.to(torch.int32),
            int(positions.numel()))

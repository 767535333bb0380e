"""The compiled automaton: container, introspection, and serialization.

Equivalent of the reference's `PFAC_context` table state plus the
introspection entry points `PFAC_dumpTransitionTable` and `PFAC_memoryUsage`
(reference: PFAC/include/PFAC_P.h:94-178, PFAC/src/PFAC.cpp:1188-1306).

Adds what the reference never had: binary save/load of compiled tables
(checkpoint/resume of the pattern compiler output) via ``save``/``load``.
"""
from __future__ import annotations

import dataclasses
import io
import json
from typing import IO, Sequence

import numpy as np

from ..status import PfacError, PfacStatus
from .parser import ParsedPatterns, parse_pattern_bytes, parse_pattern_file, patterns_from_list
from .tables import DenseTable, HashTable, build_dense_table, build_hash_table
from .trie import CHAR_SET, TRAP_STATE, CompactTrie, build_trie

_MAGIC = "pfac-tpu-automaton-v1"


@dataclasses.dataclass
class Automaton:
    """A fully compiled PFAC automaton (host-side arrays only)."""

    num_states: int
    num_final_states: int
    initial_state: int
    num_leaves: int
    max_pattern_len: int
    pattern_ids: np.ndarray       # int32[k]: sorted idx -> original 1-based ID
    pattern_lens: np.ndarray      # int32[k+1]: ID -> length, [0] unused
    sorted_patterns: tuple[bytes, ...]
    trie: CompactTrie | None
    dense: DenseTable | None = None
    hash: HashTable | None = None

    # ---------------------------------------------------------------- build
    @classmethod
    def from_parsed(
        cls, parsed: ParsedPatterns, *, dense: bool = False,
        hashed: bool = False
    ) -> "Automaton":
        """Compile patterns. Tables are LAZY by default — the reference
        also binds only the active perf mode's encoding
        (PFAC_bindTable, reference: PFAC/src/PFAC.cpp:321-342); eagerly
        materializing the dense S x 257 matrix costs gigabytes for
        100K-signature rulesets whose device path never reads it.
        dense=True / hashed=True force materialization; consumers use
        ensure_dense()/ensure_hash() otherwise."""
        if parsed.num_patterns == 0:
            raise PfacError(PfacStatus.INVALID_PARAMETER, "no patterns")
        trie = build_trie(parsed)
        a = cls(
            num_states=trie.num_states,
            num_final_states=trie.num_final_states,
            initial_state=trie.initial_state,
            num_leaves=trie.num_leaves,
            max_pattern_len=parsed.max_pattern_len,
            pattern_ids=parsed.pattern_ids,
            pattern_lens=parsed.pattern_lens,
            sorted_patterns=parsed.sorted_patterns,
            trie=trie,
        )
        if dense:
            a.dense = build_dense_table(trie)
        if hashed:
            a.hash = build_hash_table(trie)
        return a

    @classmethod
    def from_patterns(cls, patterns: Sequence[bytes], **kw) -> "Automaton":
        return cls.from_parsed(patterns_from_list(patterns), **kw)

    @classmethod
    def from_pattern_file(cls, path: str, **kw) -> "Automaton":
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            raise PfacError(PfacStatus.FILE_OPEN_ERROR, str(e)) from e
        return cls.from_pattern_bytes(data, **kw)

    @classmethod
    def from_pattern_bytes(cls, data: bytes, **kw) -> "Automaton":
        nat = cls._from_native(data, **kw)
        if nat is not None:
            return nat
        return cls.from_parsed(parse_pattern_bytes(data), **kw)

    @classmethod
    def _from_native(cls, data: bytes, *, dense: bool = False,
                     hashed: bool = False):
        """Fast path through the C++ host compiler (core/native.py);
        returns None when the native library is unavailable."""
        from . import native

        out = native.compile_patterns(data)
        if out is None or "error" in out:
            return None
        rows: list[list[tuple[int, int]]] = [[] for _ in range(out["num_states"])]
        for s, ch, nxt in out["edges"]:
            rows[int(s)].append((int(ch), int(nxt)))
        trie = CompactTrie(
            rows=rows,
            num_states=out["num_states"],
            num_final_states=out["num_patterns"],
            initial_state=out["initial_state"],
            num_leaves=out["num_leaves"],
        )
        trie._edges = np.ascontiguousarray(out["edges"], dtype=np.int32)
        lens = np.asarray(out["pat_len_by_id"], dtype=np.int32)
        pattern_ids = np.asarray(out["pat_id"], dtype=np.int32)
        sorted_patterns = tuple(
            bytes(data[int(o) : int(o) + int(lens[int(pid)])])
            for o, pid in zip(out["pat_offset"], pattern_ids)
        )
        a = cls(
            num_states=trie.num_states,
            num_final_states=trie.num_final_states,
            initial_state=trie.initial_state,
            num_leaves=trie.num_leaves,
            max_pattern_len=int(lens.max()) if lens.size else 0,
            pattern_ids=pattern_ids,
            pattern_lens=lens,
            sorted_patterns=sorted_patterns,
            trie=trie,
        )
        if hashed:
            a.ensure_hash()
        if dense:
            # honor an explicit request (parity with from_parsed); by
            # default dense stays lazy — device paths build from the
            # edge list, the host matrix serves the golden model / dump
            a.ensure_dense()
        return a

    def ensure_dense(self) -> DenseTable:
        if self.dense is None:
            if self.trie is None:
                raise PfacError(PfacStatus.INTERNAL_ERROR, "no trie to build from")
            self.dense = build_dense_table(self.trie)
        return self.dense

    def ensure_hash(self) -> HashTable:
        if self.hash is None:
            if self.trie is None:
                raise PfacError(PfacStatus.INTERNAL_ERROR, "no trie to build from")
            self.hash = build_hash_table(self.trie)
        return self.hash

    # ------------------------------------------------------------- queries
    def pattern_by_id(self, pattern_id: int) -> bytes:
        """Original pattern text for a 1-based pattern ID."""
        idx = int(np.nonzero(self.pattern_ids == pattern_id)[0][0])
        return self.sorted_patterns[idx]

    # --------------------------------------------------------------- dump
    def dump_transition_table(self, fp: IO[str] | None = None) -> str:
        """Human-readable automaton dump.

        Same content/format as `PFAC_dumpTransitionTable`
        (reference: PFAC/src/PFAC.cpp:1188-1246).
        """
        out = io.StringIO()
        out.write(
            f"# Transition table: number of states = {self.num_states}, "
            f"initial state = {self.initial_state}\n"
        )
        out.write("# (current state, input character) -> next state \n")
        if self.trie is not None:
            rows = self.trie.rows
            row_iter = ((s, rows[s]) for s in range(len(rows)))
        else:
            dense = self.ensure_dense()
            row_iter = (
                (s, [(ch, int(dense.table[s, ch])) for ch in range(CHAR_SET)
                     if dense.table[s, ch] != TRAP_STATE])
                for s in range(self.num_states)
            )
        for state, row in row_iter:
            for ch, nxt in row:
                if nxt != TRAP_STATE:
                    if 32 <= ch <= 126:
                        out.write(f"({state:4d},{chr(ch):>4}) -> {nxt} \n")
                    else:
                        out.write(f"({state:4d},{ch:4.2x}) -> {nxt} \n")

        out.write(f"# Output table: number of final states = {self.num_final_states}\n")
        out.write("# [final state] [matched pattern ID] [pattern length] [pattern(string literal)] \n")
        by_id = {}
        for i, p in enumerate(self.sorted_patterns):
            by_id[int(self.pattern_ids[i])] = p
        for state in range(1, self.num_final_states + 1):
            pattern_id = state
            plen = int(self.pattern_lens[pattern_id])
            text = _print_string(by_id[pattern_id])
            out.write(f"{state:5d} {pattern_id:5d} {plen:5d}    {text}\n")

        s = out.getvalue()
        if fp is not None:
            fp.write(s)
        return s

    def dump_reorder_pattern(self, fp: IO[str] | None = None) -> str:
        """Sorted-pattern dump, the reference's `dump_reorderPattern`
        (reference: PFAC/src/PFAC_reorder_Table.cpp:334-387): one line per
        pattern in lexicographic order — original 1-based ID, length, text.
        """
        out = io.StringIO()
        out.write("# [original pattern ID] [pattern length] [pattern(string literal)]\n")
        for i, p in enumerate(self.sorted_patterns):
            pid = int(self.pattern_ids[i])
            out.write(f"{pid:5d} {len(p):5d}    {_print_string(p)}\n")
        s = out.getvalue()
        if fp is not None:
            fp.write(s)
        return s

    def match_histogram(self, match: "np.ndarray") -> dict[int, int]:
        """Per-pattern-ID occurrence counts from a dense match vector
        (observability aid; the reference only reports a total count)."""
        counts = np.bincount(
            np.asarray(match, dtype=np.int64).clip(0),
            minlength=self.num_final_states + 1,
        )
        return {i: int(c) for i, c in enumerate(counts) if i > 0 and c > 0}

    def memory_usage(self, perf_mode: str = "dense") -> str:
        """Table footprint report, equivalent of `PFAC_memoryUsage`
        (reference: PFAC/src/PFAC.cpp:1250-1306)."""
        out = io.StringIO()
        if perf_mode == "dense":
            d = self.ensure_dense()
            out.write("time-driven: 2-D explicit matrix\n")
            out.write(f"PFAC_table = {d.num_states} x {CHAR_SET} int = {d.size_in_bytes} bytes\n")
            total = float(d.size_in_bytes)
            out.write(f"total amount = {total/1024./1024.:7.2f} MB\n")
        else:
            h = self.ensure_hash()
            out.write("space-driven: hash table\n")
            size_row = h.num_states * 8
            out.write(f"hashRowPtr = {h.num_states} int2 = {size_row} bytes\n")
            out.write(f"hashValPtr = {h.num_entries} int2 = {h.size_in_bytes} bytes\n")
            size_init = CHAR_SET * 4
            out.write(f"tableOfInitialState = {CHAR_SET} int = {size_init} bytes\n")
            total = float(size_row + h.size_in_bytes + size_init)
            out.write(f"total amount = {total/1024./1024.:7.2f} MB\n")
            dense_bytes = float(self.num_states) * CHAR_SET * 4
            out.write(f"(hash table)/(2-D table) = {total/dense_bytes:5.3f}\n")
            out.write(f"|hashValPtr|/S = {h.num_entries/float(h.num_states):5.2f}\n")
        s_cnt = self.num_states - 1
        f_cnt = self.num_final_states
        l_cnt = self.num_leaves
        out.write(f"S = number of states (ignore s0) = {s_cnt} \n")
        out.write(f"F = number of final states = {f_cnt} \n")
        out.write(f"L = number of leaf nodes = {l_cnt}\n")
        denom = (s_cnt - 1) if s_cnt > 1 else 1
        out.write(f"1 + 71*(F-1)/(S-1) = {1.0 + 71.0*(f_cnt-1.0)/denom:5.2f}\n")
        out.write(f"1 + 71*(L-1)/(S-1) = {1.0 + 71.0*(l_cnt-1.0)/denom:5.2f}\n")
        out.write(
            f"hash uses int2: 2*(2 + 71*(F-1)/(S-1))= {2.0*(2.0 + 71.0*(f_cnt-1.0)/denom):5.2f}\n"
        )
        return out.getvalue()

    # ------------------------------------------------------ checkpointing
    def save(self, path: str) -> None:
        """Binary checkpoint of the compiled automaton (not in the reference;
        it recompiles from the pattern file every run)."""
        meta = {
            "magic": _MAGIC,
            "num_states": self.num_states,
            "num_final_states": self.num_final_states,
            "initial_state": self.initial_state,
            "num_leaves": self.num_leaves,
            "max_pattern_len": self.max_pattern_len,
            "patterns_hex": [p.hex() for p in self.sorted_patterns],
        }
        arrays = {
            "pattern_ids": self.pattern_ids,
            "pattern_lens": self.pattern_lens,
        }
        if self.dense is not None:
            arrays["dense_table"] = self.dense.table
        if self.hash is not None:
            arrays["hash_row_ptr"] = self.hash.row_ptr
            arrays["hash_val"] = self.hash.val
            arrays["hash_init_row"] = self.hash.init_row
        if self.trie is not None:
            # flatten adjacency rows: (state, ch, next) triplets in order
            trip = [
                (s, ch, nxt)
                for s, row in enumerate(self.trie.rows)
                for ch, nxt in row
            ]
            arrays["trie_rows"] = np.asarray(trip, dtype=np.int32).reshape(-1, 3)
        np.savez_compressed(path, meta=json.dumps(meta), **arrays)

    @classmethod
    def load(cls, path: str) -> "Automaton":
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if meta.get("magic") != _MAGIC:
                raise PfacError(PfacStatus.INVALID_PARAMETER, "not a pfac-tpu automaton file")
            trie = None
            if "trie_rows" in z:
                rows: list[list[tuple[int, int]]] = [[] for _ in range(meta["num_states"])]
                for s, ch, nxt in z["trie_rows"]:
                    rows[int(s)].append((int(ch), int(nxt)))
                trie = CompactTrie(
                    rows=rows,
                    num_states=meta["num_states"],
                    num_final_states=meta["num_final_states"],
                    initial_state=meta["initial_state"],
                    num_leaves=meta["num_leaves"],
                )
            a = cls(
                num_states=meta["num_states"],
                num_final_states=meta["num_final_states"],
                initial_state=meta["initial_state"],
                num_leaves=meta["num_leaves"],
                max_pattern_len=meta["max_pattern_len"],
                pattern_ids=np.asarray(z["pattern_ids"], dtype=np.int32),
                pattern_lens=np.asarray(z["pattern_lens"], dtype=np.int32),
                sorted_patterns=tuple(bytes.fromhex(h) for h in meta["patterns_hex"]),
                trie=trie,
            )
            if "dense_table" in z:
                a.dense = DenseTable(table=np.asarray(z["dense_table"], dtype=np.int32))
            if "hash_row_ptr" in z:
                a.hash = HashTable(
                    row_ptr=np.asarray(z["hash_row_ptr"], dtype=np.int32),
                    val=np.asarray(z["hash_val"], dtype=np.int32),
                    init_row=np.asarray(z["hash_init_row"], dtype=np.int32),
                )
        return a


def _print_string(p: bytes) -> str:
    """Reference's printString rendering (PFAC_reorder_Table.cpp:93-105)."""
    out = ['"']
    for ch in p:
        if 32 <= ch <= 126:
            out.append(chr(ch))
        else:
            out.append(f"{ch:2.2x}")
    out.append('"')
    return "".join(out)

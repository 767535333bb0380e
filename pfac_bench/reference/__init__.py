"""The benchmark's plain reference: a failureless Aho-Corasick matcher in
numpy and plain torch, built from the pattern list alone.

It imports nothing of the program under test and takes nothing the program
has made: it builds its own trie from the same patterns and walks the same
input bytes. ``pfac.py`` holds it.
"""
from .pfac import Trie, build, match_dense, reduce_form

__all__ = ["Trie", "build", "match_dense", "reduce_form"]

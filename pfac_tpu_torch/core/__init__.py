"""The automaton compiler: parser, trie, tables, CHD builders, automaton.

The port's own copies of ``pfac_tpu.core``'s numpy host modules, so that
the port imports nothing of the reference package. Both packages compile
the same automaton and build bit-identical tables from it
(``tests/test_torch_core.py`` holds them equal).
"""
from . import automaton, chd, native, parser, tables, trie
from .automaton import Automaton

__all__ = ["Automaton", "automaton", "chd", "native", "parser", "tables",
           "trie"]

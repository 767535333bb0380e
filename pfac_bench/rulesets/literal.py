"""A ruleset given in full in the configuration: its patterns as strings,
each taken as ``latin-1`` bytes (one byte a character, 0-255), in order.

Params: ``patterns`` (a list of strings).
"""
from __future__ import annotations


def make(params: dict) -> list[bytes]:
    return [p.encode("latin-1") for p in params["patterns"]]

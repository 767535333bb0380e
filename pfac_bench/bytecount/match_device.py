"""``match_device``: 1 byte read and a 4-byte ID written a position."""


def least_bytes(n: int, matches: int | None) -> int:
    return 5 * n

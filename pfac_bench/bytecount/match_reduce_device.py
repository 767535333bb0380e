"""``match_reduce_device``: 1 byte read a position, a 4-byte ID and a
4-byte position written a match, and the 4-byte count."""


def least_bytes(n: int, matches: int | None) -> int:
    if matches is None:
        raise ValueError("match_reduce_device's bytes need the match count")
    return n + 8 * matches + 4

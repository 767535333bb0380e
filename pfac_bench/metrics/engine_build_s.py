"""Seconds from ``Matcher(...)`` to the first request's result being
complete: the automaton, the engine's tables, the kernels' library loaded
(built in a checkout's first run) and the first call's program; the
benchmark's own span on the host clock."""


def read(run) -> float | None:
    return run.engine_build_s

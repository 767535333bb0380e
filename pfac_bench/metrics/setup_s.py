"""Seconds from the process's start to the first timed request: imports,
the ruleset and the batches made from the seed, the handle built, the
kernels built or loaded, every shape warmed up; host clock."""


def read(run) -> float | None:
    return run.setup_s

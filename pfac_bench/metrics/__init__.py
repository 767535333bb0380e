"""Metric readers, one file a metric (``metrics/<name>.py``), found by the
metric's name in ``BENCHMARK.json``. Each has ``read(run)``, which takes the
number from a :class:`pfac_bench.harness.Run` and returns it, or None where
the run has nothing to read (the harness then leaves the metric out: a
share of a roofline or of a peak is never reported as 0)."""

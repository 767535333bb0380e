"""The benchmark of ``pfac_tpu_torch``, the PyTorch and CUDA port: cells
named in ``BENCHMARK.json`` at the root of the repo, each a configuration
(``configs/``) under a traffic mix (``traffic/``), run by ``run.py``.

The yardstick lives here, apart from the program: the traffic generators
(``rulesets/``, ``corpora/``), the operations and what they need
(``ops/``, ``bytecount/``, ``peaks.json``), the reduction from the
profiler's trace to metrics (``devtrace.py``, ``metrics/``) and the plain
reference that decides ``correct`` (``reference/``). Nothing here imports
JAX or the JAX package.
"""

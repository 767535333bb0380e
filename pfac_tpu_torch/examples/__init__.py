"""The port's examples, counterparts of the repository's
``examples/simple_example*.py``: run with ``python -m
pfac_tpu_torch.examples.<name> [--device cpu]``."""

"""The benchmark's own tests (``python -m pytest pfac_bench/tests -q``).
The tests that need a card are marked ``cuda`` and skip inside the test
where none is present."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU (skips where none is present)")

"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

Tests that need the card carry the ``cuda`` marker and decide inside the
test whether one is present."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")

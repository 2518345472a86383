"""Registers the marker of the tests that need a CUDA device (the same
``gpu`` marker as the repository's ``tests/``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")

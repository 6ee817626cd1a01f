"""Pytest settings shared by every test directory: the markers."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's kernels); skips "
        "without one")

"""Pytest settings shared by every test directory: the markers, and one
intra-op thread for the port's CPU tensors in each test process (the
suite runs several processes side by side, and the port's small tensors
gain nothing from threads that contend for the same cores)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's kernels); skips "
        "without one")
    try:
        import torch
    except ImportError:
        return
    torch.set_num_threads(1)

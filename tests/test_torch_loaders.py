"""The port's MNIST loader against the JAX package's on the MNIST artifacts
in Data/mnist."""

import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu.data import loaders as jloaders
from vae_posterior_consistency_tpu_torch.data import loaders as tloaders


def test_data_loader_mnist_matches_jax():
    got = tloaders.data_loader_mnist("Data", "reg_EDDI1", 30, 64,
                                     device="cpu")
    want = jloaders.data_loader_mnist("Data", "reg_EDDI1", 30, 64)
    assert got.obs_dim == want.obs_dim == 784
    for stage in ("train", "test"):
        g, w = getattr(got, stage), getattr(want, stage)
        assert g.stage == w.stage == stage and g.n == w.n
        for name in ("x", "mask"):
            t = getattr(g, name)
            assert t.dtype == torch.float32 and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(getattr(w, name)))
    assert got.test.n == 179


def test_loader_on_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        tloaders.data_loader_mnist("Data", "reg_EDDI1", 30, 64)

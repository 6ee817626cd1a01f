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


@pytest.mark.parametrize("transform", ["minmax", "stand"])
@pytest.mark.parametrize("vae_type", ["reg_vae1", "reg_vae2", "vanilla_vae3"])
def test_data_loader_matches_jax_on_wine(vae_type, transform):
    got = tloaders.data_loader("Data", vae_type, 50, 64, "wine",
                               data_transform=transform, device="cpu")
    want = jloaders.data_loader("Data", vae_type, 50, 64, "wine",
                                data_transform=transform)
    assert got.obs_dim == want.obs_dim == 13
    for stage in ("train", "test"):
        g, w = getattr(got, stage), getattr(want, stage)
        assert g.stage == w.stage == stage and g.n == w.n
        for name in ("x", "mask"):
            t = getattr(g, name)
            assert t.dtype == torch.float32 and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(getattr(w, name)))


def test_data_loader_keeps_the_unguarded_divide(tmp_path):
    """A constant column gives NaN, as in the reference and the JAX
    package; an unknown transform is refused."""
    base = tmp_path / "tiny"
    base.mkdir()
    data = torch.tensor([[1.0, 2.0], [1.0, 3.0], [1.0, 5.0]])
    torch.save(data, base / "data.pt")
    torch.save(torch.ones(3, 2), base / "mask_30_missing1.pt")
    (base / "train_index1.csv").write_text("0,1\n")
    (base / "test_index1.csv").write_text("2\n")
    for transform in ("minmax", "stand"):
        got = tloaders.data_loader(str(tmp_path), "reg_vae1", 30, 2, "tiny",
                                   data_transform=transform, device="cpu")
        want = jloaders.data_loader(str(tmp_path), "reg_vae1", 30, 2, "tiny",
                                    data_transform=transform)
        assert torch.isnan(got.train.x[:, 0]).all()
        np.testing.assert_array_equal(got.train.x.numpy(),
                                      np.asarray(want.train.x))
        np.testing.assert_array_equal(got.test.x.numpy(),
                                      np.asarray(want.test.x))
    with pytest.raises(ValueError, match="data_transform"):
        tloaders.data_loader(str(tmp_path), "reg_vae1", 30, 2, "tiny",
                             data_transform="zscore", device="cpu")

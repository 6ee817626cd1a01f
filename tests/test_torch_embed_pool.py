"""Fused embed+pool (kernel B2f) in the port: its plain version against the
JAX package's Pallas kernel (interpret mode off-TPU) and the JAX reference,
and the wrapper's routing. The CUDA kernel itself is tested on the card by
tests/test_torch_kernels_cuda.py."""

import jax
import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu.ops import fused_embed_pool as jfep
from vae_posterior_consistency_tpu_torch.ops import _build
from vae_posterior_consistency_tpu_torch.ops import fused_embed_pool as tfep


def _case(seed, B, D, K, S):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (B, D)).astype(np.float32)
    masks = (rng.random((S, B, D)) < 0.7).astype(np.float32)
    A = (rng.standard_normal((D, K)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((D, K)) * 0.3).astype(np.float32)
    return x, masks, A, C


# the sums over d run in another order in each implementation
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("K", [4, 10])
@pytest.mark.parametrize("D", [13, 130])
def test_plain_matches_jax_kernel_and_reference(D, K, S):
    arrays = _case(D * 100 + K * 10 + S, 7, D, K, S)  # B=7: ragged tiles
    got = tfep.embed_pool(*map(torch.from_numpy, arrays)).numpy()
    pallas = np.asarray(jax.jit(jfep.embed_pool)(*arrays))
    ref = np.asarray(jfep.embed_pool_reference(*arrays))
    assert got.shape == (S, 7, K)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


def test_cpu_tensors_take_the_plain_version_without_counting():
    arrays = [torch.from_numpy(a) for a in _case(0, 5, 9, 3, 1)]
    before = tfep.embed_pool.launches
    np.testing.assert_array_equal(tfep.embed_pool(*arrays).numpy(),
                                  tfep.embed_pool_reference(*arrays).numpy())
    assert tfep.embed_pool.launches == before


def test_non_cpu_tensors_are_never_routed_to_the_plain_version():
    arrays = [torch.from_numpy(a).to("meta") for a in _case(0, 5, 9, 3, 1)]
    with pytest.raises(ValueError, match="CUDA"):
        tfep.embed_pool(*arrays)
    mixed = [torch.from_numpy(a) for a in _case(0, 5, 9, 3, 1)]
    mixed[2] = mixed[2].to("meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        tfep.embed_pool(*mixed)


def test_kernel_build_without_nvcc_raises():
    try:
        _build.nvcc()
    except RuntimeError:
        pass
    else:
        pytest.skip("nvcc is installed")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library("embed_pool")

"""Fused posterior tail (kernel B1) in the port: its plain forward against the
JAX package's Pallas kernel (interpret mode off-TPU) and its jnp reference,
and the autograd Function's closed-form backward against the JAX custom VJP
and against torch autograd through the plain forward. The CUDA kernel itself
is tested on the card by tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu.ops import fused_posterior as jfp
from vae_posterior_consistency_tpu_torch.ops import fused_posterior as tfp

#: sums over B*L cells run in another order in each implementation
TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed, B, L):
    rng = np.random.default_rng(seed)
    mean_q, mean_p = (rng.standard_normal((2, B, L)) * 0.8).astype(np.float32)
    logvar_q, logvar_p = rng.uniform(-2.0, 1.0, (2, B, L)).astype(np.float32)
    eps_q, eps_p = rng.standard_normal((2, B, L)).astype(np.float32)
    return mean_q, logvar_q, mean_p, logvar_p, eps_q, eps_p


def _cotangents(seed, B, L):
    rng = np.random.default_rng(seed + 1)
    dz_q, dz_p = rng.standard_normal((2, B, L)).astype(np.float32)
    dkl = rng.standard_normal(3).astype(np.float32)
    return dz_q, dz_p, dkl


#: ragged; the training shape; two row blocks of the JAX kernel
SHAPES = [(7, 3), (64, 10), (600, 10)]  # 600 > jfp._BLOCK_ROWS = 512


@pytest.mark.parametrize("B,L", SHAPES)
def test_plain_forward_matches_jax_kernel_and_reference(B, L):
    arrays = _case(B * 10 + L, B, L)
    got = [t.numpy() for t in tfp.fused_posterior(*map(torch.from_numpy,
                                                       arrays))]
    pallas = jax.jit(jfp.fused_posterior)(*arrays)
    ref = jfp.fused_posterior_reference(*arrays)
    for i, (g, p, r) in enumerate(zip(got, pallas, ref)):
        assert g.shape == np.shape(p), i
        np.testing.assert_allclose(g, np.asarray(p), err_msg=str(i), **TOL)
        np.testing.assert_allclose(g, np.asarray(r), err_msg=str(i), **TOL)


@pytest.mark.parametrize("B,L", SHAPES)
def test_backward_matches_jax_custom_vjp_and_autograd(B, L):
    arrays = _case(B * 10 + L + 1, B, L)
    dz_q, dz_p, dkl = _cotangents(B, B, L)
    _, vjp = jax.vjp(jfp.fused_posterior, *map(jnp.asarray, arrays))
    want = vjp(tuple(map(jnp.asarray, (dz_q, dz_p, dkl[0], dkl[1], dkl[2]))))

    inputs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    outs = tfp.fused_posterior(*inputs)
    cts = [torch.from_numpy(dz_q), torch.from_numpy(dz_p),
           *torch.from_numpy(dkl)]
    got = torch.autograd.grad(outs, inputs, cts)

    plain_inputs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    plain = torch.autograd.grad(
        tfp.fused_posterior_reference(*plain_inputs), plain_inputs, cts)
    assert len(got) == 6  # mean_q, logvar_q, mean_p, logvar_p, eps_q, eps_p
    for i, (g, w, p) in enumerate(zip(got, want, plain)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=str(i),
                                   **TOL)
        np.testing.assert_allclose(g.numpy(), p.numpy(), err_msg=str(i),
                                   **TOL)


def test_strided_inputs_take_the_same_values():
    """The statistics arrive as column halves of the encoder output."""
    arrays = [torch.from_numpy(a) for a in _case(3, 9, 4)]
    h = torch.cat([arrays[0], arrays[1]], dim=1)  # [B, 2L]
    mean_q, logvar_q = h.chunk(2, dim=1)
    assert not mean_q.is_contiguous()
    got = tfp.fused_posterior(mean_q, logvar_q, *arrays[2:])
    want = tfp.fused_posterior_reference(*arrays)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_without_counting():
    arrays = [torch.from_numpy(a) for a in _case(0, 5, 3)]
    before = tfp.fused_posterior.launches
    for g, w in zip(tfp.fused_posterior(*arrays),
                    tfp.fused_posterior_reference(*arrays)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert tfp.fused_posterior.launches == before


def test_non_cpu_tensors_are_never_routed_to_the_plain_version():
    arrays = [torch.from_numpy(a).to("meta") for a in _case(0, 5, 3)]
    with pytest.raises(ValueError, match="CUDA"):
        tfp.fused_posterior(*arrays)
    mixed = [torch.from_numpy(a) for a in _case(0, 5, 3)]
    mixed[4] = mixed[4].to("meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        tfp.fused_posterior(*mixed)

"""Fused posterior tail (kernel B1) in the port: its plain forward against the
JAX package's Pallas kernel (interpret mode off-TPU) and its jnp reference,
and the autograd Function's closed-form backward against the JAX custom VJP,
the JAX `_bwd` and torch autograd through the plain forward, in the forms a
training step gives it: gradients for the statistics only or for all six
inputs, expanded cotangents, a zero KL_reg cotangent, and statistics that are
strided halves of one encoder output. The CUDA kernels themselves are tested
on the card by tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu.ops import fused_posterior as jfp
from vae_posterior_consistency_tpu_torch.ops import _kernel
from vae_posterior_consistency_tpu_torch.ops import fused_posterior as tfp
from torch_b1 import NEEDS, encoder_output, statistics

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
    before = _kernel.launches.copy()
    for g, w in zip(tfp.fused_posterior(*arrays),
                    tfp.fused_posterior_reference(*arrays)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert _kernel.launches == before


def test_non_cpu_tensors_are_never_routed_to_the_plain_version():
    arrays = [torch.from_numpy(a).to("meta") for a in _case(0, 5, 3)]
    with pytest.raises(ValueError, match="CUDA"):
        tfp.fused_posterior(*arrays)
    mixed = [torch.from_numpy(a) for a in _case(0, 5, 3)]
    mixed[4] = mixed[4].to("meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        tfp.fused_posterior(*mixed)


def _jax_bwd(arrays, dz_q, dz_p, dkl):
    """The JAX package's closed-form VJP (`_bwd`), as numpy arrays."""
    cts = (jnp.asarray(dz_q), jnp.asarray(dz_p), *map(jnp.float32, dkl))
    return [np.asarray(g) for g in jfp._bwd(tuple(map(jnp.asarray, arrays)),
                                            cts)]


@pytest.mark.parametrize("needs", sorted(NEEDS))
@pytest.mark.parametrize("B,L", SHAPES)
def test_function_gradients_match_jax_bwd_for_each_needs_subset(B, L, needs):
    arrays = _case(B + L + 7, B, L)
    dz_q, dz_p, dkl = _cotangents(B + 3, B, L)
    want = _jax_bwd(arrays, dz_q, dz_p, dkl)
    inputs = [torch.from_numpy(a).requires_grad_(n)
              for a, n in zip(arrays, NEEDS[needs])]
    z_q, z_p, kl = tfp.FusedPosterior.apply(*inputs)
    wanted = [t for t in inputs if t.requires_grad]
    got = torch.autograd.grad((z_q, z_p, kl), wanted,
                              (torch.from_numpy(dz_q), torch.from_numpy(dz_p),
                               torch.from_numpy(dkl)))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, err_msg=str(i), **TOL)


class _Ctx:
    """What autograd hands `FusedPosterior.backward`."""

    def __init__(self, saved, needs):
        self.saved_tensors = tuple(saved)
        self.needs_input_grad = tuple(needs)


@pytest.mark.parametrize("needs", sorted(NEEDS))
def test_backward_returns_none_for_inputs_that_need_no_gradient(needs):
    arrays = [torch.from_numpy(a) for a in _case(5, 6, 4)]
    dz_q, dz_p, dkl = map(torch.from_numpy, _cotangents(5, 6, 4))
    got = tfp.FusedPosterior.backward(_Ctx(arrays, NEEDS[needs]), dz_q, dz_p,
                                      dkl)
    assert len(got) == 6
    assert [g is not None for g in got] == list(NEEDS[needs])


def test_gradients_with_expanded_cotangents_from_sum():
    """A `.sum()` upstream hands dz over as an expanded tensor (stride 0)."""
    B, L = 9, 5
    arrays = _case(11, B, L)
    inputs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    z_q, z_p, kl_q, kl_p, kl_reg = tfp.fused_posterior(*inputs)
    loss = z_q.sum() + 2.0 * z_p.sum() + 3.0 * kl_q - kl_p + 0.5 * kl_reg
    got = torch.autograd.grad(loss, inputs)
    ones = np.ones((B, L), np.float32)
    want = _jax_bwd(arrays, ones, 2.0 * ones,
                    np.array([3.0, -1.0, 0.5], np.float32))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, err_msg=str(i), **TOL)
    # and the Function itself takes cotangents with zero strides
    dz = torch.ones(1, 1).expand(B, L)
    assert dz.stride() == (0, 0)
    direct = tfp.FusedPosterior.backward(
        _Ctx(map(torch.from_numpy, arrays), (True,) * 6), dz, 2.0 * dz,
        torch.tensor(3.0).expand(3))
    want = _jax_bwd(arrays, ones, 2.0 * ones, np.full(3, 3.0, np.float32))
    for i, (g, w) in enumerate(zip(direct, want)):
        np.testing.assert_allclose(g.numpy(), w, err_msg=str(i), **TOL)


def test_gradients_when_kl_reg_is_unused():
    """Under `ml_reg` the loss never reads KL_reg: its cotangent is the zero
    that unbind's backward fills in."""
    B, L = 12, 6
    arrays = _case(13, B, L)
    dz_q, dz_p, dkl = _cotangents(13, B, L)
    dkl[2] = 0.0
    inputs = [torch.from_numpy(a).requires_grad_(n)
              for a, n in zip(arrays, NEEDS["statistics"])]
    z_q, z_p, kl_q, kl_p, _ = tfp.fused_posterior(*inputs)
    got = torch.autograd.grad(
        (z_q, z_p, kl_q, kl_p), inputs[:4],
        (torch.from_numpy(dz_q), torch.from_numpy(dz_p),
         torch.tensor(dkl[0]), torch.tensor(dkl[1])))
    want = _jax_bwd(arrays, dz_q, dz_p, dkl)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, err_msg=str(i), **TOL)


def test_gradients_through_strided_halves_of_one_encoder_output():
    """The statistics are column halves (mean, logvar) and row halves (q, p)
    of one [2B, 2L] encoder output, as in the dense families' stacked
    stream: row stride 2L, and one gradient buffer dh for all four."""
    B, L = 8, 5
    arrays = _case(17, B, L)
    dz_q, dz_p, dkl = _cotangents(17, B, L)
    h = encoder_output(*map(torch.from_numpy, arrays[:4])).requires_grad_()
    stats = statistics(h)
    assert all(t.stride() == (2 * L, 1) for t in stats)
    outs = tfp.fused_posterior(*stats, *map(torch.from_numpy, arrays[4:]))
    (dh,) = torch.autograd.grad(
        outs, h, (torch.from_numpy(dz_q), torch.from_numpy(dz_p),
                  *torch.from_numpy(dkl)))
    g = _jax_bwd(arrays, dz_q, dz_p, dkl)
    want = encoder_output(*map(torch.tensor, g[:4]))
    np.testing.assert_allclose(dh.numpy(), want.numpy(), **TOL)


def test_cpu_backward_counts_no_launch():
    inputs = [torch.from_numpy(a).requires_grad_() for a in _case(1, 4, 3)]
    before = _kernel.launches.copy()
    z_q, z_p, kl_q, kl_p, kl_reg = tfp.fused_posterior(*inputs)
    (z_q.sum() + z_p.sum() + kl_q + kl_p + kl_reg).backward()
    assert all(t.grad is not None for t in inputs)
    assert _kernel.launches == before


def test_non_cpu_tensors_never_reach_the_plain_backward(monkeypatch):
    def plain(*args):
        raise AssertionError("the plain backward ran on non-CPU tensors")

    monkeypatch.setattr(tfp, "fused_posterior_backward", plain)
    arrays = [torch.from_numpy(a) for a in _case(0, 5, 3)]
    cts = [torch.from_numpy(c) for c in _cotangents(0, 5, 3)]
    meta = [t.to("meta") for t in arrays]
    with pytest.raises(ValueError, match="CUDA"):
        tfp.FusedPosterior.backward(_Ctx(meta, NEEDS["statistics"]),
                                    *(t.to("meta") for t in cts))
    # CPU statistics with one cotangent elsewhere: not all on the CPU, so
    # the kernel's wrapper takes it and refuses
    with pytest.raises(ValueError):
        tfp.FusedPosterior.backward(_Ctx(arrays, NEEDS["all"]), cts[0],
                                    cts[1].to("meta"), cts[2])
    before = _kernel.launches["fused_posterior_bwd"]
    with pytest.raises(ValueError, match="CUDA"):
        tfp.fused_posterior_backward_kernel(meta, *(t.to("meta")
                                                    for t in cts))
    assert _kernel.launches["fused_posterior_bwd"] == before


# ---------------------------------------------------------------------------
# the replica axis and the vmap rule
# ---------------------------------------------------------------------------


#: which of the six inputs the replicas share (not vmapped): none; the
#: noise (an ensemble whose replicas share their streams, the validation
#: draws); the p-branch statistics and eps_q
SHARED = {"none": (), "noise": (4, 5), "mixed": (2, 3, 4)}


@pytest.mark.parametrize("shared", sorted(SHARED))
@pytest.mark.parametrize("R", [1, 3])
def test_vmap_equals_a_loop_over_replicas(R, shared):
    """`fused_posterior` under torch.func.vmap over R replicas, some inputs
    shared (in_dims None): the values and the gradients of a summed loss
    equal those of a Python loop over the replicas; the forward and the
    backward each run once for all replicas."""
    B, L = 9, 5
    arrays = [np.stack([a] * R) for a in _case(31, B, L)]
    for j in range(6):
        arrays[j] = arrays[j] + np.float32(0.1) * np.arange(R, dtype=np.float32
                                                           )[:, None, None]
    inputs = [torch.from_numpy(a[0] if j in SHARED[shared] else a)
              .requires_grad_() for j, a in enumerate(arrays)]
    w = torch.linspace(0.5, 2.0, 5)

    def loss(*xs):
        z_q, z_p, kl_q, kl_p, kl_reg = tfp.fused_posterior(*xs)
        return ((z_q ** 2).sum() + z_p.sum() + w[0] * kl_q + w[1] * kl_p
                + w[2] * kl_reg)

    calls = []
    real = tfp.FusedPosterior.forward

    def counted(*xs):
        calls.append(tuple(xs[0].shape))
        return real(*xs)

    tfp.FusedPosterior.forward = staticmethod(counted)
    try:
        dims = tuple(None if j in SHARED[shared] else 0 for j in range(6))
        per = torch.func.vmap(loss, in_dims=dims)(*inputs)
    finally:
        tfp.FusedPosterior.forward = staticmethod(real)
    assert calls == [(R, B, L)]
    got = torch.autograd.grad(per.sum(), inputs)
    loop_inputs = [t.detach().clone().requires_grad_() for t in inputs]
    want_per = torch.stack([
        loss(*(t if j in SHARED[shared] else t[r]
               for j, t in enumerate(loop_inputs))) for r in range(R)])
    want = torch.autograd.grad(want_per.sum(), loop_inputs)
    torch.testing.assert_close(per, want_per, **TOL)
    for i, (g, w_) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w_, **TOL, msg=str(i))


def test_replica_form_is_each_replica_s_single_run_form():
    """The [R, B, L] form of the Function and of both plain versions: each
    replica's outputs and gradients equal its own [B, L] call's."""
    R, B, L = 4, 7, 3
    arrays = [np.stack([_case(40 + r, B, L)[j] for r in range(R)])
              for j in range(6)]
    cts = [np.stack([_cotangents(40 + r, B, L)[j] for r in range(R)])
           for j in range(3)]
    inputs = [torch.from_numpy(a) for a in arrays]
    z_q, z_p, kl = tfp.FusedPosterior.apply(*inputs)
    assert z_q.shape == z_p.shape == (R, B, L) and kl.shape == (R, 3)
    grads = tfp.FusedPosterior.backward(
        _Ctx(inputs, (True,) * 6), *map(torch.from_numpy, cts))
    for r in range(R):
        one = [t[r] for t in inputs]
        zq1, zp1, kl1 = tfp.FusedPosterior.apply(*one)
        torch.testing.assert_close(z_q[r], zq1, rtol=0, atol=0)
        torch.testing.assert_close(kl[r], kl1, **TOL)
        g1 = tfp.FusedPosterior.backward(
            _Ctx(one, (True,) * 6), *(torch.from_numpy(c[r]) for c in cts))
        for g, w_ in zip(grads, g1):
            torch.testing.assert_close(g[r], w_, **TOL)

"""Fused embed+pool (kernels B2f and B2b) in the port: its plain forward and
backward against the JAX package's Pallas kernels (interpret mode off-TPU)
and the JAX reference, the autograd Function's gradients, and the wrapper's
routing. The CUDA kernels themselves are tested on the card by
tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu.ops import fused_embed_pool as jfep
from vae_posterior_consistency_tpu_torch.ops import _build
from vae_posterior_consistency_tpu_torch.ops import _kernel
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
# (D, K, S): every combination of D in {13, 130}, K in {4, 10} and S in
# {1, 2}, then the shapes the CUDA kernels take beyond those (more than 32
# features, more than two masks), each against the JAX kernel
SHAPES = [(D, K, S) for S in (1, 2) for K in (4, 10) for D in (13, 130)] + [
    (13, 33, 1), (130, 33, 2), (13, 64, 2), (130, 64, 1), (13, 10, 3),
    (130, 4, 3), (130, 64, 3)]


@pytest.mark.parametrize("D,K,S", SHAPES)
def test_plain_matches_jax_kernel_and_reference(D, K, S):
    arrays = _case(D * 100 + K * 10 + S, 7, D, K, S)  # B=7: ragged tiles
    got = tfep.embed_pool(*map(torch.from_numpy, arrays)).numpy()
    pallas = np.asarray(jax.jit(jfep.embed_pool)(*arrays))
    ref = np.asarray(jfep.embed_pool_reference(*arrays))
    assert got.shape == (S, 7, K)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("D,K,S", SHAPES)
def test_backward_and_function_gradients_match_jax_kernel_vjp(D, K, S):
    arrays = _case(D * 100 + K * 10 + S + 5, 7, D, K, S)
    g = np.random.default_rng(D + K + S).standard_normal(
        (S, 7, K)).astype(np.float32)
    _, vjp = jax.vjp(jfep.embed_pool, *map(jnp.asarray, arrays))
    want = jax.jit(vjp)(jnp.asarray(g))  # the Pallas _bwd_call, interpreted
    names = ("dx", "dmasks", "dA", "dC")

    # the plain backward, directly and through the wrapper
    plain_bwd = tfep.embed_pool_bwd_reference(*map(torch.from_numpy, arrays),
                                              torch.from_numpy(g))
    wrapped = tfep.embed_pool_bwd(*map(torch.from_numpy, arrays),
                                  torch.from_numpy(g))
    for name, a, b, c in zip(names, plain_bwd, want, wrapped):
        assert a.shape == np.shape(b), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
        np.testing.assert_array_equal(c.numpy(), a.numpy(), err_msg=name)
    assert tfep.embed_pool_bwd(*map(torch.from_numpy, arrays),
                               torch.from_numpy(g), dmasks=False)[1] is None

    # the autograd Function, against JAX and autograd of the plain forward
    inputs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = torch.autograd.grad(tfep.embed_pool(*inputs), inputs,
                              torch.from_numpy(g))
    plain_inputs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    autograd = torch.autograd.grad(
        tfep.embed_pool_reference(*plain_inputs), plain_inputs,
        torch.from_numpy(g))
    for name, a, b, c in zip(names, got, want, autograd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
        np.testing.assert_allclose(a.numpy(), c.numpy(), err_msg=name, **TOL)


def test_cpu_tensors_take_the_plain_version_without_counting():
    arrays = [torch.from_numpy(a) for a in _case(0, 5, 9, 3, 1)]
    before = _kernel.launches.copy()
    np.testing.assert_array_equal(tfep.embed_pool(*arrays).numpy(),
                                  tfep.embed_pool_reference(*arrays).numpy())
    g = torch.ones(1, 5, 3)
    for a, b in zip(tfep.embed_pool_bwd(*arrays, g),
                    tfep.embed_pool_bwd_reference(*arrays, g)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert _kernel.launches == before


def test_non_cpu_tensors_are_never_routed_to_the_plain_version():
    arrays = [torch.from_numpy(a).to("meta") for a in _case(0, 5, 9, 3, 1)]
    with pytest.raises(ValueError, match="CUDA"):
        tfep.embed_pool(*arrays)
    mixed = [torch.from_numpy(a) for a in _case(0, 5, 9, 3, 1)]
    mixed[2] = mixed[2].to("meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        tfep.embed_pool(*mixed)
    with pytest.raises(ValueError, match="CUDA"):
        tfep.embed_pool_bwd(*arrays, torch.ones(1, 5, 3, device="meta"))


@pytest.mark.parametrize("B,D,K,want", [
    (512, 784, 10, (10, 2, 4, True)),  # serving: 128 blocks of 4 rows
    (64, 784, 10, (10, 8, 1, False)),  # training: 64 blocks of 1 row
    (4096, 784, 10, (10, 1, 16, True)),  # two blocks an SM
    (1, 784, 10, (10, 8, 1, False)),
    (7, 13, 64, (16, 8, 1, False)),  # four chunks of k on grid y
    (5, 100, 140, (16, 8, 1, False)),  # nine chunks: 8 x 16, then 12
    (179, 784, 33, (11, 2, 5, True)),  # three chunks of 11
    (200, 20000, 10, (10, 4, 2, False)),  # A, C too large to stage
])
def test_forward_plan_at_the_main_shapes(B, D, K, want):
    assert tfep.fwd_plan(B, D, K, n_sm=132) == want


@pytest.mark.parametrize("B", [1, 2, 3, 7, 64, 131, 132, 133, 512, 2112,
                               4096, 524296])
@pytest.mark.parametrize("K", [1, 10, 16, 17, 64, 140])
def test_forward_plan_covers_every_row_and_feature(B, K):
    k_chunk, segments, rows, _ = tfep.fwd_plan(B, 784, K, n_sm=132)
    n_kc = -(-K // k_chunk)
    tiles = -(-B // rows)
    assert 1 <= k_chunk <= tfep.CHUNK_K and (n_kc - 1) * k_chunk < K
    assert tiles * rows >= B > (tiles - 1) * rows
    assert segments in (1, 2, 4, 8)
    # a pass takes no more row slots than the tile has rows
    assert tfep.WARPS // segments <= rows
    # at most one wave of blocks (two from 16 rows an SM on), and at least
    # half of that where B allows
    waves = 2 if B >= 16 * 132 else 1
    assert tiles * n_kc < waves * 132 + n_kc
    assert 2 * tiles >= min(B, -(-waves * 132 // n_kc))


def test_kernel_build_without_nvcc_raises():
    try:
        _build.nvcc()
    except RuntimeError:
        pass
    else:
        pytest.skip("nvcc is installed")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library("embed_pool")


# ---------------------------------------------------------------------------
# the replica axis and the vmap rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shared", ["none", "x", "x_and_masks"])
@pytest.mark.parametrize("R", [1, 3])
def test_vmap_equals_a_loop_over_replicas(R, shared):
    """`embed_pool` under torch.func.vmap over R replicas, each with its
    own A and C, x (and the masks) shared where the replicas share their
    rows: values and gradients equal a Python loop over the replicas, and
    the Function runs once for all replicas (the CPU form of the one
    launch)."""
    S, B, D, K = 2, 5, 13, 10
    reps = [_case(50 + r, B, D, K, S) for r in range(R)]
    x, masks, A, C = (torch.from_numpy(np.stack([c[j] for c in reps]))
                      for j in range(4))
    shared_x = shared != "none"
    shared_m = shared == "x_and_masks"
    inputs = [x[0] if shared_x else x, masks[0] if shared_m else masks, A, C]
    inputs = [t.clone().requires_grad_() for t in inputs]
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (S, B, K)).astype(np.float32))

    def loss(x_, m_, a_, c_):
        return (tfep.embed_pool(x_, m_, a_, c_) * g).sum()

    calls = []
    real = tfep.EmbedPool.forward

    def counted(*xs):
        calls.append(tuple(xs[0].shape))
        return real(*xs)

    tfep.EmbedPool.forward = staticmethod(counted)
    try:
        per = torch.func.vmap(loss, in_dims=(
            None if shared_x else 0, None if shared_m else 0, 0, 0))(*inputs)
    finally:
        tfep.EmbedPool.forward = staticmethod(real)
    assert calls == [(R, B, D)]
    got = torch.autograd.grad(per.sum(), inputs)
    loop = [t.detach().clone().requires_grad_() for t in inputs]
    want_per = torch.stack([loss(
        loop[0] if shared_x else loop[0][r],
        loop[1] if shared_m else loop[1][r], loop[2][r], loop[3][r])
        for r in range(R)])
    want = torch.autograd.grad(want_per.sum(), loop)
    torch.testing.assert_close(per, want_per, **TOL)
    for name, a, b in zip(("dx", "dmasks", "dA", "dC"), got, want):
        torch.testing.assert_close(a, b, **TOL, msg=name)


def test_replica_form_of_the_plain_versions_is_each_replica_s():
    """x [R,B,D], masks [R,S,B,D], A, C [R,D,K]: each replica's output and
    gradients (dA, dC summed over its own rows only) are its [B,D] call's,
    against the JAX kernel on that replica."""
    R, S, B, D, K = 3, 2, 7, 13, 4
    reps = [_case(60 + r, B, D, K, S) for r in range(R)]
    stacked = [torch.from_numpy(np.stack([c[j] for c in reps]))
               for j in range(4)]
    g = np.random.default_rng(3).standard_normal((R, S, B, K)).astype(
        np.float32)
    out = tfep.embed_pool(*stacked)
    grads = tfep.embed_pool_bwd(*stacked, torch.from_numpy(g))
    assert out.shape == (R, S, B, K)
    for r in range(R):
        np.testing.assert_allclose(
            out[r].numpy(), np.asarray(jax.jit(jfep.embed_pool)(*reps[r])),
            **TOL)
        _, vjp = jax.vjp(jfep.embed_pool, *map(jnp.asarray, reps[r]))
        for got, want in zip(grads, jax.jit(vjp)(jnp.asarray(g[r]))):
            np.testing.assert_allclose(got[r].numpy(), np.asarray(want),
                                       **TOL)

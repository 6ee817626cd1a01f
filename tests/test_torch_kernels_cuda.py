"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips without a CUDA device: a
CUDA kernel has no CPU mode. This file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu_torch.ops import fused_embed_pool as fep
from vae_posterior_consistency_tpu_torch.ops import fused_posterior as fp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, S, B, D, K, device):
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(0.0, 1.0, (B, D)),
              rng.random((S, B, D)) < 0.7,
              rng.standard_normal((D, K)) * 0.3,
              rng.standard_normal((D, K)) * 0.3)
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("S,B,D,K", [
    (1, 1, 784, 10), (1, 8, 784, 10), (1, 64, 784, 10), (1, 179, 784, 10),
    (1, 512, 784, 10), (2, 64, 784, 10), (2, 7, 13, 4), (1, 33, 300, 16),
    (2, 5, 1000, 32), (1, 3, 257, 1), (2, 4096, 784, 10), (3, 64, 784, 10),
    (2, 64, 784, 64), (3, 17, 100, 140), (1, 9, 20000, 10),
    (2, 300, 20000, 10)])
def test_embed_pool_kernel_matches_plain(cuda, S, B, D, K):
    args = _case(S * 1000 + B + K, S, B, D, K, cuda)
    before = fep.embed_pool.launches
    got = fep.embed_pool(*args)
    torch.cuda.synchronize()
    assert fep.embed_pool.launches == before + 1
    # the sums over d run in another order in the kernel
    torch.testing.assert_close(got, fep.embed_pool_reference(*args),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("S,B,D,K,segments,rows", [
    (1, 512, 784, 10, 2, 4), (2, 64, 784, 10, 8, 1), (3, 37, 300, 33, 4, 3),
    (2, 19, 13, 4, 1, 8), (1, 9, 1000, 16, 2, 2)])
def test_every_forward_kernel_matches_plain(cuda, staged, S, B, D, K,
                                            segments, rows):
    """Both forms of the forward kernel at tilings `fwd_plan` may or may not
    choose."""
    args = _case(S + B + D + K, S, B, D, K, cuda)
    k_chunk = -(-K // -(-K // fep.CHUNK_K))
    got = fep._embed_pool_fwd_kernel(*args, S, B, D, K,
                                     (k_chunk, segments, rows, staged))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fep.embed_pool_reference(*args),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_embed_pool_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, masks, A, C = _case(0, 1, 4, 20, 5, cuda)
    # three masks and 140 features are computed, as the JAX kernel does
    for args in ((x, masks.expand(3, 4, 20).contiguous(), A, C),
                 (x, masks, A.repeat(1, 28), C.repeat(1, 28))):
        torch.testing.assert_close(fep.embed_pool(*args),
                                   fep.embed_pool_reference(*args),
                                   rtol=1e-5, atol=1e-4)
    with pytest.raises(TypeError, match="float32"):
        fep.embed_pool(x.double(), masks, A, C)
    with pytest.raises(ValueError, match="contiguous"):
        fep.embed_pool(x.t().contiguous().t(), masks, A, C)
    with pytest.raises(ValueError, match="contiguous"):
        fep.embed_pool(x, masks, A.t().contiguous().t(), C)
    with pytest.raises(ValueError, match="one CUDA device"):
        fep.embed_pool(x.cpu(), masks, A, C)
    with pytest.raises(ValueError, match="g lies on"):
        fep.embed_pool_bwd(x, masks, A, C, torch.ones(1, 4, 5))
    # inputs that need a gradient go through the backward kernel
    A.requires_grad_()
    before = fep.embed_pool_bwd.launches
    fep.embed_pool(x, masks, A, C).sum().backward()
    assert fep.embed_pool_bwd.launches == before + 1 and A.grad is not None


def _assert_bwd_close(got, want, B, dmasks=True):
    # dx and dmasks sum K terms; dA and dC sum B terms, in another order in
    # the kernel (each warp over its rows, then the warps in order)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    if dmasks:
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    else:
        assert got[1] is None
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-5 * B)
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-5 * B)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("B", [1, 7, 64, 179])
@pytest.mark.parametrize("dmasks", [True, False])
def test_embed_pool_bwd_kernel_matches_plain(cuda, S, B, dmasks):
    D, K = 784, 10
    x, masks, A, C = _case(S * 1000 + B, S, B, D, K, cuda)
    g = torch.randn(S, B, K, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(B))
    before = fep.embed_pool_bwd.launches
    got = fep.embed_pool_bwd(x, masks, A, C, g, dmasks=dmasks)
    torch.cuda.synchronize()
    assert fep.embed_pool_bwd.launches == before + 1
    want = fep.embed_pool_bwd_reference(x, masks, A, C, g)
    _assert_bwd_close(got, want, B, dmasks)


@pytest.mark.cuda
@pytest.mark.parametrize("S,B,D,K", [
    (2, 64, 784, 20), (2, 64, 784, 64), (3, 64, 784, 10), (3, 33, 300, 140),
    (2, 4096, 784, 10), (1, 524296, 13, 10)])
def test_embed_pool_bwd_kernel_matches_plain_at_any_shape(cuda, S, B, D, K):
    """More than 16 features (chunks of k), more than two masks, and more
    rows than the grid of the first backward design could take."""
    x, masks, A, C = _case(S * 1000 + B + K, S, B, D, K, cuda)
    g = torch.randn(S, B, K, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(K))
    before = fep.embed_pool_bwd.launches
    got = fep.embed_pool_bwd(x, masks, A, C, g)
    torch.cuda.synchronize()
    assert fep.embed_pool_bwd.launches == before + 1
    assert got[2].is_contiguous() and got[3].is_contiguous()
    want = fep.embed_pool_bwd_reference(x, masks, A, C, g)
    _assert_bwd_close(got, want, B)


@pytest.mark.cuda
@pytest.mark.parametrize("S,B,D,K", [
    (1, 512, 784, 10), (2, 64, 784, 10), (3, 100, 784, 64)])
def test_embed_pool_kernels_give_the_same_bits_twice(cuda, S, B, D, K):
    x, masks, A, C = _case(7, S, B, D, K, cuda)
    g = torch.randn(S, B, K, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(7))
    device = torch.cuda.current_device()
    first = [fep.embed_pool(x, masks, A, C),
             *fep.embed_pool_bwd(x, masks, A, C, g)]
    second = [fep.embed_pool(x, masks, A, C),
              *fep.embed_pool_bwd(x, masks, A, C, g)]
    torch.cuda.synchronize()
    for u, v in zip(first, second):
        assert torch.equal(u, v)
    # the training form skips dx and dmasks and writes the same dA, dC
    _, _, dA, dC = fep._embed_pool_bwd_kernel(x, masks, A, C, g, S, B, D, K,
                                              want_dx=False, want_dm=False)
    assert torch.equal(dA, first[3]) and torch.equal(dC, first[4])
    # the entry points give the caller's current device back
    assert torch.cuda.current_device() == device


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", [(64, 10), (7, 3), (4096, 10), (1, 1)])
def test_fused_posterior_kernel_matches_plain(cuda, B, L):
    gen = torch.Generator(device=cuda).manual_seed(B + L)
    mq, mp, eq, ep = torch.randn(4, B, L, device=cuda, generator=gen)
    lq, lp = torch.rand(2, B, L, device=cuda, generator=gen) * 3.0 - 2.0
    before = fp.fused_posterior.launches
    got = fp.fused_posterior(mq, lq, mp, lp, eq, ep)
    torch.cuda.synchronize()
    assert fp.fused_posterior.launches == before + 1
    want = fp.fused_posterior_reference(mq, lq, mp, lp, eq, ep)
    # z elementwise; the three KL sums over B*L cells in another order
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
    # strided statistics (column halves of the encoder output)
    h = torch.cat([mq, lq], dim=1)
    again = fp.fused_posterior(*h.chunk(2, dim=1), mp, lp, eq, ep)
    for g, w in zip(again, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
def test_functions_gradients_match_autograd_of_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    stats = [torch.randn(64, 10, device=cuda, generator=gen)
             for _ in range(6)]
    cts = [torch.randn(64, 10, device=cuda, generator=gen),
           torch.randn(64, 10, device=cuda, generator=gen),
           *torch.randn(3, device=cuda, generator=gen)]
    a = [t.clone().requires_grad_() for t in stats]
    b = [t.clone().requires_grad_() for t in stats]
    got = torch.autograd.grad(fp.fused_posterior(*a), a, cts)
    want = torch.autograd.grad(fp.fused_posterior_reference(*b), b, cts)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)

    x, masks, A, C = _case(5, 2, 64, 784, 10, cuda)
    g = torch.randn(2, 64, 10, device=cuda, generator=gen)
    a = [t.clone().requires_grad_() for t in (x, masks, A, C)]
    b = [t.clone().requires_grad_() for t in (x, masks, A, C)]
    got = torch.autograd.grad(fep.embed_pool(*a), a, g)
    want = torch.autograd.grad(fep.embed_pool_reference(*b), b, g)
    for i, (u, v) in enumerate(zip(got, want)):
        torch.testing.assert_close(u, v, rtol=1e-5,
                                   atol=1e-5 * (64 if i >= 2 else 1))

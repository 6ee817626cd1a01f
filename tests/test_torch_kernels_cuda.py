"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips without a CUDA device: a
CUDA kernel has no CPU mode. This file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu_torch.ops import _kernel
from vae_posterior_consistency_tpu_torch.ops import fused_embed_pool as fep
from vae_posterior_consistency_tpu_torch.ops import fused_posterior as fp
from torch_b1 import NEEDS, encoder_output, statistics


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
    before = _kernel.launches["embed_pool_fwd"]
    got = fep.embed_pool(*args)
    torch.cuda.synchronize()
    assert _kernel.launches["embed_pool_fwd"] == before + 1
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
    # the wrapper lays out any stride of x and A (`_kernel_layout`): the
    # contiguous call's result, in one launch
    want = fep.embed_pool(x, masks, A, C)
    for args in ((x.t().contiguous().t(), masks, A, C),
                 (x, masks, A.t().contiguous().t(), C)):
        before = _kernel.launches["embed_pool_fwd"]
        got = fep.embed_pool(*args)
        torch.cuda.synchronize()
        assert _kernel.launches["embed_pool_fwd"] == before + 1
        assert torch.equal(got, want)
    # the layer below it keeps the kernels' contract
    with pytest.raises(ValueError, match="contiguous"):
        fep._check(x, masks, A.t().contiguous().t(), C, "embed_pool")
    with pytest.raises(ValueError, match="one CUDA device"):
        fep.embed_pool(x.cpu(), masks, A, C)
    with pytest.raises(ValueError, match="g lies on"):
        fep.embed_pool_bwd(x, masks, A, C, torch.ones(1, 4, 5))
    # inputs that need a gradient go through the backward kernel
    A.requires_grad_()
    before = _kernel.launches["embed_pool_bwd"]
    fep.embed_pool(x, masks, A, C).sum().backward()
    assert _kernel.launches["embed_pool_bwd"] == before + 1
    assert A.grad is not None


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
    before = _kernel.launches["embed_pool_bwd"]
    got = fep.embed_pool_bwd(x, masks, A, C, g, dmasks=dmasks)
    torch.cuda.synchronize()
    assert _kernel.launches["embed_pool_bwd"] == before + 1
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
    before = _kernel.launches["embed_pool_bwd"]
    got = fep.embed_pool_bwd(x, masks, A, C, g)
    torch.cuda.synchronize()
    assert _kernel.launches["embed_pool_bwd"] == before + 1
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
    before = _kernel.launches["fused_posterior_fwd"]
    got = fp.fused_posterior(mq, lq, mp, lp, eq, ep)
    torch.cuda.synchronize()
    assert _kernel.launches["fused_posterior_fwd"] == before + 1
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
    before = _kernel.launches["fused_posterior_bwd"]
    got = torch.autograd.grad(fp.fused_posterior(*a), a, cts)
    assert _kernel.launches["fused_posterior_bwd"] == before + 1
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


def _device_ops(fn):
    """Device operations (kernels, copies, fills) one call of `fn` puts on
    the card, from torch.profiler: the larger of two counts, as a trace may
    drop an event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == DeviceType.CUDA
                          and not getattr(e, "is_user_annotation", False)))
    return max(counts)


def _stats(B, L, device, seed, strided=True):
    """The six inputs of B1; with `strided`, the four statistics are the
    row and column halves of one [2B, 2L] encoder output (row stride 2L)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mq, mp, eq, ep = torch.randn(4, B, L, device=device, generator=gen)
    lq, lp = torch.rand(2, B, L, device=device, generator=gen) * 3.0 - 2.0
    if strided:
        mq, lq, mp, lp = statistics(encoder_output(mq, lq, mp, lp))
    return mq, lq, mp, lp, eq, ep


def _cotangents(B, L, device, seed, expanded=False):
    gen = torch.Generator(device=device).manual_seed(seed)
    if expanded:  # what a `.sum()` upstream hands over: stride 0
        dz_q, dz_p = torch.randn(2, 1, 1, device=device, generator=gen)
        dkl = torch.randn(1, device=device, generator=gen)
        return dz_q.expand(B, L), dz_p.expand(B, L), dkl.expand(3)
    dz_q, dz_p = torch.randn(2, B, L, device=device, generator=gen)
    return dz_q, dz_p, torch.randn(3, device=device, generator=gen)


@pytest.mark.cuda
@pytest.mark.parametrize("expanded", [False, True])
@pytest.mark.parametrize("needs", sorted(NEEDS))
@pytest.mark.parametrize("B,L", [(64, 10), (7, 3), (4096, 10), (1, 1)])
def test_fused_posterior_bwd_kernel_matches_plain(cuda, B, L, needs,
                                                  expanded):
    stats = _stats(B, L, cuda, B + L)
    cts = _cotangents(B, L, cuda, B * L, expanded)
    before = _kernel.launches["fused_posterior_bwd"]
    got = fp.fused_posterior_backward_kernel(stats, *cts, needs=NEEDS[needs])
    torch.cuda.synchronize()
    assert _kernel.launches["fused_posterior_bwd"] == before + 1
    want = fp.fused_posterior_backward(stats, *cts)
    for g, w, n in zip(got, want, NEEDS[needs]):
        if not n:
            assert g is None
            continue
        assert g.shape == (B, L) and g.is_contiguous()
        # elementwise: the exponentials and roundings of another compiler
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", [(65536, 10), (262144, 10)])
def test_fused_posterior_forward_is_one_launch_at_any_size(cuda, B, L):
    """One block walks all the cells, many turns a thread, and sums them in
    the same launch."""
    stats = _stats(B, L, cuda, 3, strided=False)
    before = _kernel.launches["fused_posterior_fwd"]
    got = fp.fused_posterior(*stats)
    torch.cuda.synchronize()
    assert _kernel.launches["fused_posterior_fwd"] == before + 1
    want = fp.fused_posterior_reference(*stats)
    # z elementwise; the three KL sums over B*L cells in another order
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
    assert _device_ops(lambda: fp.fused_posterior_kernel(*stats)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", [(64, 10), (4096, 10), (65536, 10)])
def test_fused_posterior_kernels_give_the_same_bits_twice(cuda, B, L):
    stats = _stats(B, L, cuda, 11)
    cts = _cotangents(B, L, cuda, 12)
    device = torch.cuda.current_device()
    first = [*fp.fused_posterior_kernel(*stats),
             *fp.fused_posterior_backward_kernel(stats, *cts)]
    second = [*fp.fused_posterior_kernel(*stats),
              *fp.fused_posterior_backward_kernel(stats, *cts)]
    torch.cuda.synchronize()
    for u, v in zip(first, second):
        assert torch.equal(u, v)
    # the entry points give the caller's current device back
    assert torch.cuda.current_device() == device


@pytest.mark.cuda
def test_fused_posterior_forward_and_backward_are_one_launch_each(cuda):
    """As a training step calls them: the Function's forward, and its
    backward for the four statistics through autograd."""
    stats = _stats(64, 10, cuda, 5)
    leaves = [t.detach().requires_grad_() for t in stats[:4]]  # stride 2L
    assert _device_ops(lambda: fp.fused_posterior_kernel(*stats)) == 1
    outs = fp.FusedPosterior.apply(*leaves, *stats[4:])
    cts = _cotangents(64, 10, cuda, 6)
    before = _kernel.launches["fused_posterior_bwd"]
    assert _device_ops(lambda: torch.autograd.grad(
        outs, leaves, cts, retain_graph=True)) == 1
    assert _kernel.launches["fused_posterior_bwd"] == before + 2


# ---------------------------------------------------------------------------
# the replica axis (ensembles)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 3, 128])
def test_fused_posterior_replica_kernels_match_plain(cuda, R):
    """[R, 64, 10]: one launch of each kernel for all replicas, each
    replica's KL its own; the noise shared (replica stride 0) reads the
    same; replica r equals the one-run kernel on its slice bit for bit."""
    B, L = 64, 10
    gen = torch.Generator(device=cuda).manual_seed(R)
    stats = [torch.randn(R, B, L, device=cuda, generator=gen)
             for _ in range(4)]
    stats[1], stats[3] = stats[1].clamp(-2, 1), stats[3].clamp(-2, 1)
    eps = torch.randn(2, B, L, device=cuda, generator=gen)
    stats += [eps[0].expand(R, B, L), eps[1].expand(R, B, L)]
    cts = [torch.randn(R, B, L, device=cuda, generator=gen),
           torch.randn(R, B, L, device=cuda, generator=gen),
           torch.randn(R, 3, device=cuda, generator=gen)]
    before = _kernel.launches.copy()
    got = fp.fused_posterior_kernel(*stats)
    grads = fp.fused_posterior_backward_kernel(stats, *cts)
    torch.cuda.synchronize()
    assert _kernel.launches - before == {"fused_posterior_fwd": 1,
                                         "fused_posterior_bwd": 1}
    z_q, z_p, kq, kp, kr = fp.fused_posterior_reference(*stats)
    for g, w in zip(got, (z_q, z_p, torch.stack([kq, kp, kr], -1))):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
    for g, w in zip(grads, fp.fused_posterior_backward(stats, *cts)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
    for r in {0, R - 1}:
        one = fp.fused_posterior_kernel(*(t[r] for t in stats))
        one_g = fp.fused_posterior_backward_kernel(
            [t[r] for t in stats], cts[0][r], cts[1][r], cts[2][r])
        for a, b in zip(one, got):
            assert torch.equal(a, b[r])
        for a, b in zip(one_g, grads):
            assert torch.equal(a, b[r])


#: float32 rounding of a pre-activation x*A + C: the kernel computes it in
#: one fma, the plain version rounds the product and then the sum, so their
#: signs may differ where it lies within a few roundings of 0
PRE_ROUNDING = 4 * torch.finfo(torch.float32).eps
#: the share of dx's elements that such a relu-boundary flip may move
FLIP_SHARE = 1e-5


def _assert_close_but_at_relu_flips(grads, want, x, A, C, what):
    """(dx, dmasks, dA, dC) of the kernel against the plain version at
    rtol 1e-5, atol 1e-4, except where a pre-activation of the element's
    sum lies within `PRE_ROUNDING` (|x*A| + |C|) of 0 (some k of its
    (b, d) for dx and dmasks, some b of its (d, k) for dA and dC). At most
    `FLIP_SHARE` of dx's elements may differ. Each flip is printed with
    the pre-activations of its row and feature."""
    xa = x[..., None] * A.unsqueeze(-3)  # [R, B, D, K]
    pre = xa + C.unsqueeze(-3)
    near = pre.abs() <= PRE_ROUNDING * (xa.abs() + C.abs().unsqueeze(-3))
    by_cell = near.any(-1)  # [R, B, D]
    allowed = (by_cell, by_cell.unsqueeze(-3).expand_as(grads[1]),
               near.any(-3), near.any(-3))
    for got, w, ok in zip(grads, want, allowed):
        torch.testing.assert_close(got[~ok], w[~ok], rtol=1e-5, atol=1e-4)
    off = ~torch.isclose(grads[0], want[0], rtol=1e-5, atol=1e-4)
    for r, b, d in off.nonzero().tolist():
        bound = PRE_ROUNDING * (xa[r, b, d].abs() + C[r, d].abs())
        print(f"{what}: relu flip at replica {r}, row {b}, feature {d}: dx "
              f"{grads[0][r, b, d].item():.6g} against "
              f"{want[0][r, b, d].item():.6g}; pre-activation per k "
              f"{pre[r, b, d].tolist()}, rounding bound {bound.tolist()}")
    assert off.sum().item() <= FLIP_SHARE * off.numel(), what


@pytest.mark.cuda
@pytest.mark.parametrize("D", [13, 784])
@pytest.mark.parametrize("R", [1, 3, 128])
def test_embed_pool_replica_kernels_match_plain(cuda, R, D):
    """x [R,64,D] (or shared), masks [R,2,64,D], A and C [R,D,10]: one
    launch of each kernel, dA and dC each replica's own, against the
    plain versions, the backward but at relu-boundary flips; R = 1 equals
    the one-run kernels bit for bit."""
    S, B, K = 2, 64, 10
    reps = [_case(100 * R + r + D, S, B, D, K, cuda) for r in range(R)]
    x, masks, A, C = (torch.stack([c[j] for c in reps]) for j in range(4))
    g = torch.randn(R, S, B, K, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(R))
    for xs in (x, x[0].expand(R, B, D)):
        before = _kernel.launches.copy()
        got = fep.embed_pool(xs, masks, A, C)
        grads = fep.embed_pool_bwd(xs, masks, A, C, g)
        torch.cuda.synchronize()
        assert _kernel.launches - before == {"embed_pool_fwd": 1,
                                             "embed_pool_bwd": 1}
        torch.testing.assert_close(
            got, fep.embed_pool_reference(xs, masks, A, C), rtol=1e-5,
            atol=1e-4)
        _assert_close_but_at_relu_flips(
            grads, fep.embed_pool_bwd_reference(xs, masks, A, C, g), xs, A,
            C, f"R={R} D={D} x shared={xs.stride(0) == 0}")
    if R == 1:
        one = fep.embed_pool(x[0], masks[0], A[0], C[0])
        one_g = fep.embed_pool_bwd(x[0], masks[0], A[0], C[0], g[0])
        got = fep.embed_pool(x, masks, A, C)
        grads = fep.embed_pool_bwd(x, masks, A, C, g)
        assert torch.equal(one, got[0])
        for a, b in zip(one_g, grads):
            assert torch.equal(a, b[0])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,fan_in,fan_out", [(64, 784, 500),
                                                 (128, 10, 500), (7, 13, 3)])
def test_bf16_product_on_the_card_matches_its_plain_version(
        cuda, rows, fan_in, fan_out):
    """`nn/core.bf16_product` (cuBLAS on bf16 operands, float32 output):
    the forward against the plain product of the widened operands (float32
    sums in another order); each gradient, the bf16 product of the
    cotangent rounded to bf16, equal to the plain formula of that form or
    one bf16 ulp from it, give or take the float32 rounding of a sum of
    up to 784 O(1) terms in another order (about 1e-6 of the largest
    output, held at 1e-5); one counted product a call."""
    from vae_posterior_consistency_tpu_torch.nn import core

    rng = np.random.default_rng(rows + fan_in)
    x, w, g = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=cuda)
               for shape in ((rows, fan_in), (fan_in, fan_out),
                             (rows, fan_out)))
    a = x.to(torch.bfloat16).requires_grad_()
    b = w.to(torch.bfloat16).requires_grad_()
    before = core.bf16_product.launches
    out = core.bf16_product(a, b)
    assert out.dtype == torch.float32
    assert core.bf16_product.launches == before + 1
    torch.testing.assert_close(out, a.detach().float() @ b.detach().float(),
                               rtol=1e-5, atol=1e-4)
    out.backward(g)
    assert core.bf16_product.launches == before + 3
    gb = g.to(torch.bfloat16).float()
    for name, got, want in (("da", a.grad, gb @ b.detach().float().T),
                            ("db", b.grad, a.detach().float().T @ gb)):
        want = want.to(torch.bfloat16).float()
        got = got.float()
        bound = (2.0 ** -7 * torch.maximum(got.abs(), want.abs())
                 + 1e-5 * want.abs().max())
        excess = ((got - want).abs() - bound).max().item()
        assert excess <= 0, (name, excess, (got - want).abs().max().item())


@pytest.mark.cuda
def test_bf16_product_vmap_rule_is_one_product(cuda):
    """Under torch.func.vmap with batched weights (an ensemble's replicas)
    and with a batched input, one product for all replicas, equal to the
    unbatched calls to float32 rounding of the sums."""
    from vae_posterior_consistency_tpu_torch.nn import core

    rng = np.random.default_rng(5)
    xs = torch.tensor(rng.standard_normal((3, 2, 16, 40)),
                      dtype=torch.bfloat16, device=cuda)
    ws = torch.tensor(rng.standard_normal((3, 40, 24)), dtype=torch.bfloat16,
                      device=cuda)
    for in_dims, args in (((0, 0), (xs, ws)), ((None, 0), (xs[0], ws)),
                          ((0, None), (xs, ws[0]))):
        before = core.bf16_product.launches
        got = torch.func.vmap(core.bf16_product, in_dims)(*args)
        assert core.bf16_product.launches == before + 1
        want = torch.stack([
            core.bf16_product(*[t[i] if d == 0 else t
                                for t, d in zip(args, in_dims)])
            for i in range(3)])
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)

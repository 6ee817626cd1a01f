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
    (2, 5, 1000, 32), (1, 3, 257, 1)])
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
def test_embed_pool_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, masks, A, C = _case(0, 1, 4, 20, 5, cuda)
    with pytest.raises(ValueError, match="S <= 2"):
        fep.embed_pool(x, masks.expand(3, 4, 20).contiguous(), A, C)
    with pytest.raises(ValueError, match="K <= 32"):
        fep.embed_pool(x, masks, A.repeat(1, 7), C.repeat(1, 7))
    with pytest.raises(TypeError, match="float32"):
        fep.embed_pool(x.double(), masks, A, C)
    with pytest.raises(ValueError, match="contiguous"):
        fep.embed_pool(x.t().contiguous().t(), masks, A, C)
    with pytest.raises(ValueError, match="one CUDA device"):
        fep.embed_pool(x.cpu(), masks, A, C)
    with pytest.raises(NotImplementedError, match="forward only"):
        fep.embed_pool(x, masks, A.requires_grad_(), C)

"""The kernel seam (`ops/_kernel`): every kernel has its plain version
registered under its name in `launches`, and a CPU call through the public
wrapper runs that plain version, looked up in its module at the call (the
property `chip_smoke.py`'s guard patches), and launches nothing. This file
imports neither JAX nor the JAX package."""

import sys

import pytest
import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.models import notmiwae
from vae_posterior_consistency_tpu_torch.ops import _kernel
from vae_posterior_consistency_tpu_torch.ops import fused_embed_pool as fep
from vae_posterior_consistency_tpu_torch.ops import fused_iw, fused_iw_mnar
from vae_posterior_consistency_tpu_torch.ops import fused_posterior as fp


def _randn(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def _posterior(backward):
    """B1 on two replicas; through autograd's backward with `backward`."""
    stats = [_randn(2, 4, 3, seed=i).requires_grad_(backward)
             for i in range(6)]
    out = fp.fused_posterior(*stats)
    if backward:
        sum(t.sum() for t in out).backward()


def _embed_pool(backward):
    """B2 at S=2, B=3, D=5, K=4; its backward both through autograd and
    through `embed_pool_bwd`."""
    x, A, C = _randn(3, 5, seed=1), _randn(5, 4, seed=2), _randn(5, 4, seed=3)
    masks = (_randn(2, 3, 5, seed=4) > 0).float()
    if not backward:
        fep.embed_pool(x, masks, A, C)
        return
    A.requires_grad_()
    fep.embed_pool(x, masks, A, C).sum().backward()
    fep.embed_pool_bwd(x, masks, A, C, _randn(2, 3, 4, seed=5))


def _iw():
    """IW1 at B=3, K=5, D=4, L=2, with the `extra` sums."""
    B, K, D, L, H = 3, 5, 4, 2, fused_iw.HIDDEN
    x, extra = _randn(B, D, seed=1), _randn(2, D, seed=2)
    mask = (_randn(B, D, seed=3) > 0).float()

    def mlp(widths, seed):
        return {f"layer{i}": {"w": _randn(*wh, seed=seed + i) * 0.1,
                              "b": _randn(wh[1], seed=seed + 10 + i) * 0.1}
                for i, wh in enumerate(widths)}

    encoder = mlp(((D, H), (H, H), (H, 2 * L)), 10)
    decoder = mlp(((L, H), (H, H), (H, 3 * D)), 30)
    with torch.no_grad():
        fused_iw.iw_fused(x, mask, extra, _randn(B, K, L), encoder, decoder,
                          5000.0)


def _iw_mnar():
    """IW2 at B=3, K=5, D=4, L=2, on seeded notMIWAE parameters."""
    cfg = RunConfig(vae_type="vanilla_notMIWAE1", latent_dim=2, valid_k=5)
    params = notmiwae.init(torch.Generator().manual_seed(0), cfg, 4,
                           device="cpu")
    mask = (_randn(3, 4, seed=3) > 0).float()
    with torch.no_grad():
        fused_iw_mnar.iw_mnar(_randn(3, 4, seed=1), mask, _randn(3, 5, 2),
                              params, cfg)


#: a CPU call of each kernel's public wrapper, by its name in `launches`
CALLS = {
    "fused_posterior_fwd": lambda: _posterior(False),
    "fused_posterior_bwd": lambda: _posterior(True),
    "embed_pool_fwd": lambda: _embed_pool(False),
    "embed_pool_bwd": lambda: _embed_pool(True),
    "iw_fused": _iw,
    "iw_mnar": _iw_mnar,
}


def test_every_kernel_has_a_plain_version_and_a_cpu_case():
    assert set(_kernel.PLAIN) == set(CALLS)


@pytest.mark.parametrize("name", sorted(CALLS))
def test_a_cpu_call_runs_the_plain_version_and_launches_nothing(
        name, monkeypatch):
    plain = _kernel.PLAIN[name]
    module = sys.modules[plain.__module__]
    assert getattr(module, plain.__name__) is plain
    ran = []

    def counted(*args):
        ran.append(name)
        return plain(*args)

    monkeypatch.setattr(module, plain.__name__, counted)
    before = _kernel.launches.copy()
    CALLS[name]()
    assert ran and _kernel.launches == before

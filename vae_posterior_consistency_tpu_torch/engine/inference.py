"""Inference utilities (port of the JAX package's `engine/inference.py`, the
completion sampler; the mutual-information estimators come with slice 8).

`completion` draws M conditional imputations of the completed data
(reference: src/utils/utils.py:192-208): M forward passes through the
model's `eval_step`, run here as one pass over the M copies of the rows
stacked.
"""

from __future__ import annotations

import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.models import get_model


def completion(params, x, mask, mask_p, M: int, cfg: RunConfig, eps=None,
               generator=None):
    """M conditional samples of the completed data, [M, N, D].

    The noise is explicit: `eps` [M, N, latent_dim], sample m's standard
    normals, or a `torch.Generator` on x's device to draw it from; by
    default one seeded with cfg.seed + 5, as the JAX package seeds its key.
    Pass at most one of the two."""
    if eps is not None and generator is not None:
        raise ValueError("completion: pass at most one of eps, generator")
    model = get_model(cfg)
    N, D = x.shape
    L = cfg.latent_dim
    if eps is None:
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(
                cfg.seed + 5)
        eps = torch.randn((M, N, L), generator=generator, device=x.device)
    if tuple(eps.shape) != (M, N, L):
        raise ValueError(f"completion: eps of shape {tuple(eps.shape)}, want "
                         f"{(M, N, L)}")

    def rows(t):
        return t.expand(M, *t.shape).reshape(M * N, D)

    with torch.no_grad():
        out = model.eval_step(params, rows(x), rows(mask),
                              None if mask_p is None else rows(mask_p),
                              eps.reshape(M * N, L).to(x.device), cfg)
    return out["x_imputed"].reshape(M, N, D)

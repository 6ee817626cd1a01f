"""Inference utilities (port of the JAX package's `engine/inference.py`, the
completion sampler; the mutual-information estimators come with the
active-learning slice).

`completion` draws M conditional imputations of the completed data
(reference: src/utils/utils.py:192-208): M forward passes through the
model's `eval_step`. For gauss and the flow they run as one pass over the
M copies of the rows stacked; for the importance-weighted families (MIWAE,
notMIWAE), whose `eval_step` already holds cfg.valid_k samples a row, one
pass a sample, since a stack would multiply those activations by M.
"""

from __future__ import annotations

import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.models import get_model


def completion(params, x, mask, mask_p, M: int, cfg: RunConfig, eps=None,
               generator=None):
    """M conditional samples of the completed data, [M, N, D].

    The noise is explicit. Sample m draws the family's evaluation noise,
    `ModelDef.eval_noise(cfg, N, D)` without "mask_p" (the caller's
    `mask_p` is used as it is): `eps` is {kind: [M, *shape]}, sample m's
    draws at index m, or a `torch.Generator` on x's device draws them, by
    default one seeded with cfg.seed + 5, as the JAX package seeds its key.
    Pass at most one of the two."""
    if eps is not None and generator is not None:
        raise ValueError("completion: pass at most one of eps, generator")
    model = get_model(cfg)
    N, D = x.shape
    shapes = {kind: (M, *shape) for kind, shape
              in model.eval_noise(cfg, N, D).items() if kind != "mask_p"}
    if eps is None:
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(
                cfg.seed + 5)
        eps = {kind: torch.randn(shape, generator=generator, device=x.device)
               for kind, shape in shapes.items()}
    got = {kind: tuple(t.shape) for kind, t in eps.items()}
    if got != shapes:
        raise ValueError(f"completion: eps of shapes {got}, want {shapes}")
    eps = eps["eps"].to(x.device)

    with torch.no_grad():
        if model.eval_kind == "miwae":
            return torch.stack([
                model.eval_step(params, x, mask, mask_p, eps[m],
                                cfg)["x_imputed"] for m in range(M)])

        def rows(t):
            return t.expand(M, *t.shape).reshape(M * N, D)

        out = model.eval_step(params, rows(x), rows(mask),
                              None if mask_p is None else rows(mask_p),
                              eps.reshape(M * N, -1), cfg)
    return out["x_imputed"].reshape(M, N, D)

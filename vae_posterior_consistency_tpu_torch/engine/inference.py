"""Inference utilities: conditional completion sampling and mutual-information
estimation (port of the JAX package's `engine/inference.py`).

`completion` draws M conditional imputations of the completed data
(reference: src/utils/utils.py:192-208): M forward passes through the
model's `eval_step`. For gauss and the flow they run as one pass over the
M copies of the rows stacked; for the importance-weighted families (MIWAE,
notMIWAE), whose `eval_step` already holds cfg.valid_k samples a row, one
pass a sample, since a stack would multiply those activations by M.

`mutual_information` is the reference's MI=True loss branch for the
Gaussian-posterior families: KL_q / B minus the KL of the aggregated
posterior to the prior (reference: src/models/VAE.py:153-158, 308-313).
`mutual_information_kde` evaluates the aggregated posterior by a Gaussian
KDE over one posterior sample a row instead. Both read the family's
`ModelDef.encode_stats`; the flow has none, and raises.
"""

from __future__ import annotations

import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.nn.tensor_utils import (
    gaussian_kde_log_eval,
)
from vae_posterior_consistency_tpu_torch.ops.math import (
    kl_diag_std,
    normal_logpdf,
    reparameterize,
)


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


def _encode_stats(cfg: RunConfig, what: str):
    model = get_model(cfg)
    if model.encode_stats is None:
        raise NotImplementedError(
            f"{what} needs a Gaussian-posterior family, not "
            f"{cfg.vae_type!r}")
    return model.encode_stats


def mutual_information(params, x, mask, cfg: RunConfig):
    """MI estimate for the Gaussian-posterior families:
    KL_q / B - KL(N(mean(mu), mean(logvar)) || N(0, I)), the 'aggregated
    posterior' the reference's coordinate-wise mean of the statistics
    (reference: src/models/VAE.py:153-158). A 0-d tensor."""
    encode_stats = _encode_stats(cfg, "mutual_information")
    with torch.no_grad():
        mean, logvar = encode_stats(params, x, mask, cfg)  # [B, L] each
        KL_q = kl_diag_std(mean, logvar)
        KL_agg = kl_diag_std(mean.mean(dim=0), logvar.mean(dim=0))
    return KL_q / x.shape[0] - KL_agg


def mutual_information_kde(params, x, mask, cfg: RunConfig, eps=None):
    """MI(x; z) ~ E_x E_{z~q(z|x)} [log q(z|x) - log q_agg(z)], q_agg a
    Gaussian KDE (Scott's rule) over one posterior sample a row, evaluated
    leave-one-out (each z_i against the other B-1 kernels). A 0-d tensor.

    The sample's noise is explicit: `eps` [B, L], or by default a
    `torch.Generator` on x's device seeded with cfg.seed + 6, as the JAX
    package seeds its key."""
    encode_stats = _encode_stats(cfg, "mutual_information_kde")
    with torch.no_grad():
        mean, logvar = encode_stats(params, x, mask, cfg)  # [B, L] each
        if eps is None:
            z = reparameterize(mean, logvar, generator=torch.Generator(
                device=x.device).manual_seed(cfg.seed + 6))
        else:
            z = reparameterize(mean, logvar, eps=eps.to(mean.device))
        log_q = normal_logpdf(z, mean, logvar).sum(dim=-1)
        log_q_agg = gaussian_kde_log_eval(z, z, loo=True)
    return (log_q - log_q_agg).mean()

"""Flow-posterior VAE family: VAEFlow / REG_VAEFlow (port of the JAX
package's `models/flow_vae.py`; reference: src/models/VAE.py:1860-2124).

The posterior is a 3-layer conditional piecewise-linear spline flow over the
latent (nn/flow.py), conditioned on an ELU encoder trunk's latent_dim**2
context (reference: src/models/VAE.py:1878, 1924-1931). KL is the
Monte-Carlo difference log q(z) - log p(z) (reference: VAE.py:1958); the reg
variant's consistency term is sum|log q_q(z_q) - log q_p(z_p)|
(reference: VAE.py:2088).

Where the JAX functions take a PRNG key, these take the flow's standard
normal base noise: `eps` [B, latent_dim] for `encode` and `eval_step`; for
`train_loss`, [2, B, latent_dim] (row 0 the q branch, row 1 the p branch)
for regularized types and [B, latent_dim] for vanilla ones. A regularized
`train_loss` runs both branches as one stacked [2B] stream through the
encoder, the flow and the decoder.

Under a torch profiler the model records the spans (`utils/tracing`)
`flow.encode` (the context trunk, in `encode` and `encoder_log_prob`),
`flow.decode` (the decoder) and `flow.likelihood` (the RE and KL sums of
`eval_step` and `train_loss`), beside `nn/flow`'s `flow.spline` (the
spline stack) and its counter `flow_rows`.
"""

from __future__ import annotations

import torch

from vae_posterior_consistency_tpu_torch.models import layers
from vae_posterior_consistency_tpu_torch.nn import flow as flowlib
from vae_posterior_consistency_tpu_torch.ops.math import (
    normal_logpdf,
    std_normal_logpdf,
)
from vae_posterior_consistency_tpu_torch.utils import tracing


def train_noise(cfg, B, D):
    """The noise a training step draws: {kind: shape}."""
    del D
    L = cfg.latent_dim
    return {"eps": (2, B, L) if cfg.info.regularized else (B, L)}


def eval_noise(cfg, B, D):
    """The noise an evaluation batch draws: {kind: shape}."""
    del D
    return {"eps": (B, cfg.latent_dim)}


def train_noise_rows(cfg):
    """The batch-row axis of each `train_noise` kind."""
    return {"eps": 1 if cfg.info.regularized else 0}


def eval_noise_rows(cfg):
    """The batch-row axis of each `eval_noise` kind."""
    del cfg
    return {"eps": 0}


def init(generator, cfg, obs_dim, device="cuda"):
    params = {
        "encoder": layers.flow_context_encoder_init(
            generator, obs_dim, cfg.hid_dim,
            context_dim=cfg.latent_dim * cfg.latent_dim, device=device),
        "decoder": layers.flow_decoder_init(generator, obs_dim,
                                            cfg.latent_dim, cfg.hid_dim,
                                            device=device),
    }
    if cfg.flow_actnorm:
        # ActNorm affines between the spline layers, identity at init
        # (reference: src/models/VAE.py:1627-1657, 1827)
        params["actnorm"] = [flowlib.actnorm_init(cfg.latent_dim, device)
                             for _ in range(flowlib.NUM_LAYERS)]
    return params


def _actnorm(params, cfg):
    """ActNorm affines, cross-checked against the config: a checkpoint
    trained without ActNorm evaluated under `-flow_actnorm true` (or vice
    versa) is a mismatch, and raises."""
    want = bool(cfg.flow_actnorm)
    have = "actnorm" in params
    if want != have:
        raise ValueError(
            f"flow_actnorm={want} but the checkpoint was trained "
            f"{'with' if have else 'without'} ActNorm layers — "
            "re-train or match the flag to the checkpoint")
    return params.get("actnorm")


def encode(params, x, mask, eps, cfg):
    """z from the flow posterior for base noise `eps`; returns (z,
    elementwise log q(z)) (reference: src/models/VAE.py:1924-1931)."""
    with tracing.span("flow.encode"):
        context = layers.flow_context_encoder_apply(params["encoder"], x,
                                                    mask)
    return flowlib.flow_forward(eps, context, cfg.latent_dim,
                                tails=cfg.flow_tails,
                                actnorm=_actnorm(params, cfg))


def encoder_log_prob(params, z, x, mask, cfg):
    """log q(z | x, mask) of an external z, the `backward` hook of AIS and
    the flow-ratio AL reward (reference: src/models/VAE.py:1933-1941)."""
    with tracing.span("flow.encode"):
        context = layers.flow_context_encoder_apply(params["encoder"], x,
                                                    mask)
    return flowlib.flow_log_prob(z, context, cfg.latent_dim,
                                 tails=cfg.flow_tails,
                                 actnorm=_actnorm(params, cfg))


def decode(params, z):
    with tracing.span("flow.decode"):
        return layers.flow_decoder_apply(params["decoder"], z)


def _re_cells(x, x_mean, x_logvar, m):
    """Element-wise NLL of the masked cells, the reference's
    mask-everything form (reference: VAE.py:1955-1956, 2082-2083)."""
    return -normal_logpdf(x * m, x_mean * m, x_logvar * m)


def _re_terms(x, x_mean, x_logvar, m, dim=None):
    cells = _re_cells(x, x_mean, x_logvar, m)
    return cells.sum() if dim is None else cells.sum(dim=dim)


def train_loss(params, x, mask, mask_p, eps, epoch, cfg):
    """Training loss (reference: VAE.py:1950-1966 vanilla; VAE.py:2075-2103
    reg); returns (loss, aux). `epoch` is unused: the flow family anneals
    nothing and has no `ml_reg` term."""
    del epoch
    B = x.shape[0]
    L = cfg.latent_dim

    if not cfg.info.regularized:
        z_q, z_logprob_q = encode(params, x, mask, eps, cfg)
        x_mean_q, x_logvar_q = decode(params, z_q)
        with tracing.span("flow.likelihood"):
            RE_q = _re_terms(x, x_mean_q, x_logvar_q, mask)
            KL_q = torch.sum(z_logprob_q - std_normal_logpdf(z_q))
            loss = (RE_q + cfg.beta * KL_q) / B
        return loss, {"RE_q": RE_q / B, "KL_q": KL_q / B}

    # both branches, q (rows :B) and p (rows B:), as one stacked stream
    x2 = torch.cat([x, x])
    m2 = torch.cat([mask, mask_p])
    z, z_logprob = encode(params, x2, m2, eps.reshape(2 * B, L), cfg)
    x_mean, x_logvar = decode(params, z)
    with tracing.span("flow.likelihood"):
        re_cells = _re_cells(x2, x_mean, x_logvar, m2)
        kl_cells = z_logprob - std_normal_logpdf(z)
        RE_q, RE_p = re_cells[:B].sum(), re_cells[B:].sum()
        KL_q, KL_p = kl_cells[:B].sum(), kl_cells[B:].sum()

        loss_q = RE_q + cfg.beta * KL_q
        loss_p = RE_p + cfg.beta * KL_p
        KL_reg = torch.sum(torch.abs(z_logprob[:B] - z_logprob[B:]))
        extra_mask = mask * (1.0 - mask_p)
        RE_extra = _re_terms(x, x_mean[:B], x_logvar[:B], extra_mask)
        loss = (loss_q + cfg.alpha * (KL_reg - loss_q + loss_p + RE_extra)
                ) / B
    return loss, {"RE_q": RE_q / B, "KL_q": KL_q / B, "RE_p": RE_p / B,
                  "KL_p": KL_p / B}


def eval_step(params, x, mask, mask_p, eps, cfg, epoch=None):
    """llh_eval semantics (reference: VAE.py:1963-1964, 2095-2106), per row:
    `mean(row_*)` equals the reference's sum/batch-size scalars. `mask_p`
    and `epoch` are unused, as in the JAX package."""
    del mask_p, epoch
    z_q, z_logprob_q = encode(params, x, mask, eps, cfg)
    x_mean_q, x_logvar_q = decode(params, z_q)
    with tracing.span("flow.likelihood"):
        row_re = _re_terms(x, x_mean_q, x_logvar_q, mask, dim=-1)
        row_re_imp = _re_terms(x, x_mean_q, x_logvar_q, 1.0 - mask, dim=-1)
        row_kl = torch.sum(z_logprob_q - std_normal_logpdf(z_q), dim=-1)
    return {
        "x_imputed": x_mean_q,
        "row_loss": row_re + cfg.beta * row_kl,
        "row_negl": row_re,
        "row_negl_imp": row_re_imp,
    }

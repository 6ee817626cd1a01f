"""Gaussian-posterior VAE family: dense / mask-augmented / EDDI-PointNet
encoders and the sigmoid decoder with fixed observation variance (port of the
JAX package's `models/gauss.py`: init, encode, decode, forward, train_loss
and eval_step).

Where the JAX functions take a PRNG key, these take the standard-normal noise
itself: `eps` [B, latent_dim] for a forward pass; for `train_loss`, `eps`
[2, B, latent_dim] (row 0 the q branch, row 1 the p branch) for regularized
types and [B, latent_dim] for vanilla ones, and `eps_z` [B, latent_dim] for
`ml_reg`.
"""

from __future__ import annotations

import math

import torch

from vae_posterior_consistency_tpu_torch.models import layers
from vae_posterior_consistency_tpu_torch.ops.fused_posterior import (
    fused_posterior,
)
from vae_posterior_consistency_tpu_torch.ops.math import (
    FIXED_X_LOGVAR,
    kl_diag_std,
    neg_gaussian_log_likelihood,
    reparameterize,
)

#: annealing denominator hard-coded by the reference (src/models/VAE.py:58,384)
MAX_EPOCH_ANNEAL = 2800.0


def _is_pointnet(cfg) -> bool:
    """EDDI/mnist families use the per-feature embedding encoder."""
    return "EDDI" in cfg.vae_type or "mnist" in cfg.vae_type


def _encoder_fns(cfg):
    mnist = cfg.data_type == "mnist"
    if _is_pointnet(cfg):
        trunk = (500, 500, 200) if mnist else (100, 50)

        def init(generator, obs_dim, device):
            return layers.pointnet_encoder_init(
                generator, obs_dim, cfg.latent_dim, cfg.K, trunk_widths=trunk,
                device=device)

        return init, layers.pointnet_encoder_apply
    if cfg.info.mask_augmented:
        def init(generator, obs_dim, device):
            return layers.dense_mask_encoder_init(
                generator, obs_dim, cfg.latent_dim, device=device)

        return init, layers.dense_mask_encoder_apply

    def init(generator, obs_dim, device):
        return layers.dense_encoder_init(generator, obs_dim, cfg.latent_dim,
                                         device=device)

    return init, layers.dense_encoder_apply


def _decoder_widths(cfg):
    return (200, 500, 500) if cfg.data_type == "mnist" else (50, 100)


def init(generator, cfg, obs_dim, device="cuda"):
    enc_init, _ = _encoder_fns(cfg)
    return {
        "encoder": enc_init(generator, obs_dim, device),
        "decoder": layers.sigmoid_decoder_init(
            generator, obs_dim, cfg.latent_dim, widths=_decoder_widths(cfg),
            device=device),
    }


def encode(params, x, mask, cfg):
    """(mean, logvar) of q(z | x, mask)."""
    _, enc_apply = _encoder_fns(cfg)
    return enc_apply(params["encoder"], x, mask)


def decode(params, z):
    """Sigmoid mean + fixed observation logvar (reference: VAE.py:397-401, 379)."""
    x_mean = layers.sigmoid_decoder_apply(params["decoder"], z)
    return x_mean, torch.full_like(x_mean, FIXED_X_LOGVAR)


def forward(params, x, mask, eps, cfg):
    mean, logvar = encode(params, x, mask, cfg)
    z = reparameterize(mean, logvar, eps=eps)
    x_mean, x_logvar = decode(params, z)
    return {"mean": mean, "logvar": logvar, "z": z, "x_mean": x_mean,
            "x_logvar": x_logvar}


_INV_VAR = math.exp(-FIXED_X_LOGVAR)
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _masked_re(x, x_mean, _x_logvar_ignored, m, dim=None):
    """Reconstruction NLL with the reference's mask-everything convention
    (reference: VAE.py:422-426), folded to closed form for the fixed
    observation logvar and a binary mask:
        m * (0.5*e^{-c}*(x-mean)^2 + 0.5*c) + log sqrt(2pi)
    The logvar argument is ignored: it is always FIXED_X_LOGVAR here."""
    del _x_logvar_ignored
    per_cell = m * (0.5 * _INV_VAR * torch.square(x - x_mean)
                    + 0.5 * FIXED_X_LOGVAR) + _LOG_SQRT_2PI
    return per_cell.sum() if dim is None else per_cell.sum(dim=dim)


def _anneal(epoch, on):
    return epoch / MAX_EPOCH_ANNEAL if on else 1.0


def train_loss(params, x, mask, mask_p, eps, epoch, cfg, eps_z=None):
    """Per-batch training loss (stage='train' path of reference
    VAE.py:403-452); returns (loss, aux).

    Vanilla (non-reg) types ignore `mask_p` and use the plain ELBO
    (reference: VAE.py:1171-1196). Regularized types run both branches
    through one encoder pass: EDDI/pointnet families pool the shared embed
    under both masks (layers.pointnet_encoder_apply_2masks), dense families
    run the stacked [2B] stream; the posterior tail (both samples and the
    three KL sums) is the fused kernel. `eps` [2, B, L] reshapes to the
    [2B, L] rows of the dense stream in the same row-major order as the JAX
    package's draw (gauss.py:185, 196)."""
    B = x.shape[0]
    info = cfg.info
    beta_scale = _anneal(epoch, cfg.beta_annealing) * cfg.beta

    if not info.regularized:
        out_q = forward(params, x, mask, eps, cfg)
        RE_q = _masked_re(x, out_q["x_mean"], out_q["x_logvar"], mask)
        KL_q = kl_diag_std(out_q["mean"], out_q["logvar"])
        loss_q = RE_q + beta_scale * KL_q
        return loss_q / B, {"RE_q": RE_q / B, "KL_q": KL_q / B}

    if _is_pointnet(cfg):
        mean_all, logvar_all = layers.pointnet_encoder_apply_2masks(
            params["encoder"], x, mask, mask_p)  # [2, B, L]
        mean_q, mean_p = mean_all[0], mean_all[1]
        logvar_q, logvar_p = logvar_all[0], logvar_all[1]
    else:
        mean_all, logvar_all = encode(params, torch.cat([x, x], dim=0),
                                      torch.cat([mask, mask_p], dim=0), cfg)
        mean_q, mean_p = mean_all[:B], mean_all[B:]
        logvar_q, logvar_p = logvar_all[:B], logvar_all[B:]
    eps_q, eps_p = eps[0], eps[1]

    z_q, z_p, KL_q, KL_p, KL_reg = fused_posterior(
        mean_q, logvar_q, mean_p, logvar_p, eps_q, eps_p)
    x_mean_all, x_logvar_all = decode(params, torch.cat([z_q, z_p], dim=0))
    xm_q, xm_p = x_mean_all[:B], x_mean_all[B:]
    xlv_q, xlv_p = x_logvar_all[:B], x_logvar_all[B:]

    RE_q = _masked_re(x, xm_q, xlv_q, mask)
    loss_q = RE_q + beta_scale * KL_q
    RE_p = _masked_re(x, xm_p, xlv_p, mask_p)
    loss_p = RE_p + beta_scale * KL_p

    if cfg.reg_type == "ml_reg":
        if eps_z is None:
            raise ValueError("train_loss: reg_type='ml_reg' needs eps_z")
        z_q2 = reparameterize(mean_q, logvar_q, eps=eps_z)
        z_loglike = -neg_gaussian_log_likelihood(z_q2, mean_p, logvar_p)
        loss = loss_q - (epoch / MAX_EPOCH_ANNEAL) * cfg.alpha * z_loglike
    elif cfg.reg_type == "kl_reg":
        extra_mask = mask * (1.0 - mask_p)
        RE_extra = _masked_re(x, xm_q, xlv_q, extra_mask)
        loss = loss_q + cfg.alpha * (KL_reg - loss_q + loss_p + RE_extra)
    else:
        raise NotImplementedError(f"reg_type={cfg.reg_type!r}")
    return loss / B, {"RE_q": RE_q / B, "KL_q": KL_q / B, "RE_p": RE_p / B,
                      "KL_p": KL_p / B}


def eval_step(params, x, mask, mask_p, eps, cfg, epoch=None):
    """stage='evaluate' + llh_eval=True semantics (reference: VAE.py:410-420,
    455-456) in per-row form. `mask_p` is unused, as in the JAX package."""
    del mask_p
    epoch = cfg.epoch if epoch is None else epoch
    out_q = forward(params, x, mask, eps, cfg)
    row_re = _masked_re(x, out_q["x_mean"], out_q["x_logvar"], mask, dim=-1)
    row_re_imp = _masked_re(x, out_q["x_mean"], out_q["x_logvar"], 1.0 - mask,
                            dim=-1)
    row_kl = kl_diag_std(out_q["mean"], out_q["logvar"], dim=-1)
    beta_scale = _anneal(float(epoch), cfg.beta_annealing) * cfg.beta
    return {
        "x_imputed": out_q["x_mean"],
        "row_loss": row_re + beta_scale * row_kl,
        "row_negl": row_re,
        "row_negl_imp": row_re_imp,
    }

"""Gaussian-posterior VAE family: dense / mask-augmented / EDDI-PointNet
encoders and the sigmoid decoder with fixed observation variance (port of the
JAX package's `models/gauss.py`, the serving half: init, encode, decode,
forward and eval_step; `train_loss` comes with the training slice).

Where the JAX functions take a PRNG key, these take the standard-normal noise
itself: `eps` [B, latent_dim].
"""

from __future__ import annotations

import math

import torch

from vae_posterior_consistency_tpu_torch.models import layers
from vae_posterior_consistency_tpu_torch.ops.math import (
    FIXED_X_LOGVAR,
    kl_diag_std,
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

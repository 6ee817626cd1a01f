"""MIWAE family: MIWAE and Reg_MIWAE (port of the JAX package's
`models/miwae.py`; reference: src/models/VAE.py:3011-3301).

The Student-t decoder likelihood and an importance-weighted bound over K
samples on a [B, K, ...] axis from one encoder pass. The JAX package's
deliberate deviations from the reference are kept (PARITY.md deviation 2):
- one z feeds both the decoder and the importance weights (the reference
  redraws z for log p(z) - log q(z), VAE.py:3086-3091);
- the [B, K] axes stay aligned (the reference's reshape round trip,
  VAE.py:3078-3081, scrambles them whenever K != B);
- the bound has no -log K (VAE.py:3092);
- the regularizer's KL is the mean over all elements (VAE.py:3270-3275).
And the reference quirks as JAX has them: a vanilla type's `row_negl`
divides by the hard-coded 5000 (VAE.py:3099), and a regularized type's
`row_negl` and `row_negl_imp` are its `row_loss`.

Where the JAX functions take a PRNG key, these take the standard normal
noise: `eps` [B, K, latent_dim] for `forward` and for a vanilla type's
`train_loss` and `eval_step`; [2, B, K, latent_dim] (row 0 the q branch,
row 1 the p branch) for a regularized type's, which runs both branches as
one stacked [2B] stream through the encoder and the decoder. K is the
noise's sample axis: cfg.train_k in training and cfg.valid_k in
evaluation, as `train_noise` and `eval_noise` give the engine.

`eval_step` runs its whole stream as one IW1 call (`ops/fused_iw`: a
CUDA kernel on the card, on the CPU its plain version, this module's eager
composition to the bit): the encoder, the per-sample terms and each row's
reductions over K, wherever it runs without gradients in float32
(`_fused`): `eval_vae`, `evaluate_sharded`, `inference.completion` and
`serve`. Where gradients are enabled or `compute_dtype('bfloat16')` is
active it runs `forward`, `_branch_terms` and `ops/fused_iw.reduce_over_k`,
as `train_loss` always runs the first two (IW1 has no backward); AIS calls
the layers itself.

Under a torch profiler the eager path records the spans `miwae.encode`
(the encoder), `miwae.decode` (the reparameterised z and the Student-t
decoder over B*K samples), `miwae.likelihood` (the Student-t log-density,
its masked sums, log p(z) and log q) and `miwae.weights` (the logsumexp
over K, the softmax and the imputation); IW1's path records only
`miwae.decode`, around the one call, which holds all of that work. The
counters (`utils/tracing`): `iw_samples` (rows x K decoded, once a
`forward` or an IW1 call) and `iw_fused_samples` (the same, once an IW1
call).
"""

from __future__ import annotations

import torch

from vae_posterior_consistency_tpu_torch.models import layers
from vae_posterior_consistency_tpu_torch.ops import fused_iw
from vae_posterior_consistency_tpu_torch.ops.math import (
    kl_diag_diag_scale_elems,
    normal_logpdf_scale,
    std_normal_logpdf,
    student_t_logpdf,
)
from vae_posterior_consistency_tpu_torch.utils import tracing

#: the reference's hard-coded divisor of a vanilla type's `row_negl`
#: (src/models/VAE.py:3099)
NEGL_DIVISOR = 5000.0


def _eps_shape(cfg, B, K):
    L = cfg.latent_dim
    return (2, B, K, L) if cfg.info.regularized else (B, K, L)


def train_noise(cfg, B, D):
    """The noise a training step draws: {kind: shape}."""
    del D
    return {"eps": _eps_shape(cfg, B, cfg.train_k)}


def eval_noise(cfg, B, D):
    """The noise an evaluation batch draws: {kind: shape}; a regularized
    type's `eval_step` reads a fresh `mask_p` (uniforms [B, D])."""
    shapes = {"mask_p": (B, D)} if cfg.info.regularized else {}
    shapes["eps"] = _eps_shape(cfg, B, cfg.valid_k)
    return shapes


def train_noise_rows(cfg):
    """The batch-row axis of each `train_noise` kind (`_eps_shape`)."""
    return {"eps": 1 if cfg.info.regularized else 0}


def eval_noise_rows(cfg):
    """The batch-row axis of each `eval_noise` kind."""
    return {"mask_p": 0, "eps": 1 if cfg.info.regularized else 0}


def init(generator, cfg, obs_dim, device="cuda"):
    return {
        "encoder": layers.miwae_encoder_init(generator, obs_dim,
                                             cfg.latent_dim, device),
        "decoder": layers.student_t_decoder_init(generator, obs_dim,
                                                 cfg.latent_dim, device),
    }


def encode(params, x, mask, cfg):
    """(mean, scale) of q(z|x,mask); scale is a softplus std
    (reference: VAE.py:3047-3059)."""
    del cfg
    return layers.miwae_encoder_apply(params["encoder"], x, mask)


def forward(params, x, mask, eps, cfg):
    """K importance samples for noise `eps` [B, K, L]; a dict of [B, K, ...]
    tensors and the [B, L] posterior statistics."""
    with tracing.span("miwae.encode"):
        mean, scale = encode(params, x, mask, cfg)
    with tracing.span("miwae.decode"):
        z = mean[:, None, :] + scale[:, None, :] * eps
        x_mean, x_scale, df = layers.student_t_decoder_apply(
            params["decoder"], z)
    tracing.count("iw_samples", eps.shape[0] * eps.shape[1])
    return {"mean": mean, "scale": scale, "z": z, "x_mean": x_mean,
            "x_scale": x_scale, "df": df}


def _branch_terms(out, x, mask):
    """(logpxobs [B,K], log_w [B,K], logpx_imp [B,K], log p(x|z) [B,K,D])
    for one encoder branch (reference bound terms: VAE.py:3073-3092)."""
    with tracing.span("miwae.likelihood"):
        m = mask[:, None, :]
        log_pxz = student_t_logpdf(x[:, None, :], out["x_mean"],
                                   out["x_scale"], out["df"])
        logpxobs = torch.sum(log_pxz * m, dim=-1)
        logpx_imp = torch.sum(log_pxz * (1.0 - m), dim=-1)
        logpz = torch.sum(std_normal_logpdf(out["z"]), dim=-1)
        logq = torch.sum(normal_logpdf_scale(
            out["z"], out["mean"][:, None, :], out["scale"][:, None, :]),
            dim=-1)
        return logpxobs, logpxobs + logpz - logq, logpx_imp, log_pxz


def _both_branches(params, x, mask, mask_p, eps, cfg):
    """The q (rows :B) and p (rows B:) branches as one stacked stream:
    (forward's dict, log_w [2B,K], log p(x|z) [2B,K,D])."""
    B = x.shape[0]
    x2, m2 = torch.cat([x, x]), torch.cat([mask, mask_p])
    out = forward(params, x2, m2, eps.reshape(2 * B, *eps.shape[2:]), cfg)
    _, log_w, _, log_pxz = _branch_terms(out, x2, m2)
    return out, log_w, log_pxz


def _neg_bound(log_w):
    """-mean_B(logsumexp_K(log_w)), no -log K, as the reference
    (VAE.py:3092)."""
    return -torch.mean(torch.logsumexp(log_w, dim=1))


def _extra_mask(mask, mask_p):
    """The cells hidden from the p branch but seen by the q branch, whose
    likelihood the regularizer rewards (reference: VAE.py:3244-3246)."""
    return mask * (1.0 - mask_p)


def _extra_sum(log_pxz, extra):
    """sum_d log p(x|z) * extra [B_extra, K] over the first B_extra rows."""
    return torch.sum(log_pxz[:extra.shape[0]] * extra[:, None, :], dim=-1)


def _row_kl_reg(mean, scale, B):
    """The mean over L of the elementwise q/p KL of the stacked statistics
    (q rows :B, p rows B:), a row."""
    return torch.mean(kl_diag_diag_scale_elems(
        mean[:B], scale[:B], mean[B:], scale[B:]), dim=-1)


def _reg_terms(mean, scale, extra_sum, B):
    """Per row: the extra likelihood reward (`extra_sum` [B, K]) meaned over
    K, and the mean over L of the elementwise q/p KL of the stacked
    statistics (q rows :B, p rows B:)."""
    return torch.mean(extra_sum, dim=1), _row_kl_reg(mean, scale, B)


#: whether `eval_step` runs IW1: the rule notMIWAE's IW2 shares (patch it
#: here to send this model's steps down the eager path)
_fused = fused_iw.fused_eval


def _fused_rows(params, x, mask, extra, eps):
    """The stream's (x_imputed, per_row, mean, scale) from one IW1 call: the
    encoder, z, the decoder, the Student-t log-density and its sums (under
    `mask`, 1 - mask and, where given, `extra` [B_extra, D] on the first
    B_extra rows), and the reductions over K (`ops/fused_iw`)."""
    with tracing.span("miwae.decode"):
        out = fused_iw.iw_fused(x, mask, extra, eps, params["encoder"],
                                params["decoder"], NEGL_DIVISOR)
    samples = eps.shape[0] * eps.shape[1]
    tracing.count("iw_samples", samples)
    tracing.count("iw_fused_samples", samples)
    return out


def _eager_rows(params, x, mask, extra, eps, cfg):
    """The same from `forward`, `_branch_terms` and the reductions over K,
    as training runs the first two."""
    out = forward(params, x, mask, eps, cfg)
    _, log_w, logpx_imp, log_pxz = _branch_terms(out, x, mask)
    extra_sum = None if extra is None else _extra_sum(log_pxz, extra)
    with tracing.span("miwae.weights"):
        x_imputed, per_row = fused_iw.reduce_over_k(
            log_w, out["x_mean"], logpx_imp, extra_sum, NEGL_DIVISOR)
    return x_imputed, per_row, out["mean"], out["scale"]


def train_loss(params, x, mask, mask_p, eps, epoch, cfg):
    """IWAE negative bound; for a regularized type the consistency
    composite (reference: VAE.py:3197-3251). Returns (loss, aux). `epoch`
    is unused: the family anneals nothing."""
    del epoch
    if not cfg.info.regularized:
        out_q = forward(params, x, mask, eps, cfg)
        _, log_w_q, _, _ = _branch_terms(out_q, x, mask)
        with tracing.span("miwae.weights"):
            neg_bound_q = _neg_bound(log_w_q)
        return neg_bound_q, {"neg_bound": neg_bound_q}

    B = x.shape[0]
    out, log_w, log_pxz = _both_branches(params, x, mask, mask_p, eps, cfg)
    with tracing.span("miwae.weights"):
        neg_bound_q = _neg_bound(log_w[:B])
        neg_bound_p = _neg_bound(log_w[B:])
    row_reg_like, row_kl_reg = _reg_terms(
        out["mean"], out["scale"],
        _extra_sum(log_pxz, _extra_mask(mask, mask_p)), B)
    # the means over all elements: rows of equal length, so the mean of the
    # row means
    reg_like = torch.mean(row_reg_like)
    KL_reg = torch.mean(row_kl_reg)
    loss = neg_bound_q + cfg.alpha * (KL_reg - neg_bound_q + neg_bound_p
                                      - reg_like)
    return loss, {"neg_bound_q": neg_bound_q, "neg_bound_p": neg_bound_p,
                  "KL_reg": KL_reg}


def eval_step(params, x, mask, mask_p, eps, cfg):
    """llh_eval semantics (reference: VAE.py:3095-3099, 3254-3258), per row:
    the importance-weighted imputation xm = sum_k w_k x_mean_k and the
    bound. `mean(row_*)` equals the reference's batch scalars. `mask_p` is
    read by regularized types only. Without gradients in float32 the whole
    stream is one IW1 call (`_fused`)."""
    B = x.shape[0]
    extra = None
    if cfg.info.regularized:
        # the q (rows :B) and p (rows B:) branches as one stacked stream
        x, mask, extra = (torch.cat([x, x]), torch.cat([mask, mask_p]),
                          _extra_mask(mask, mask_p))
        eps = eps.reshape(2 * B, *eps.shape[2:])
    if _fused():
        x_imputed, per_row, mean, scale = _fused_rows(params, x, mask, extra,
                                                      eps)
    else:
        x_imputed, per_row, mean, scale = _eager_rows(params, x, mask, extra,
                                                      eps, cfg)
    if not cfg.info.regularized:
        negl = per_row[1]
        return {"x_imputed": x_imputed, "row_loss": per_row[0],
                "row_negl": negl, "row_negl_imp": negl}

    row_neg_bound_q, row_neg_bound_p = per_row[0, :B], per_row[0, B:]
    row_kl_reg = _row_kl_reg(mean, scale, B)
    row_loss = row_neg_bound_q + cfg.alpha * (
        row_kl_reg - row_neg_bound_q + row_neg_bound_p - per_row[2, :B])
    return {"x_imputed": x_imputed[:B], "row_loss": row_loss,
            "row_negl": row_loss, "row_negl_imp": row_loss}

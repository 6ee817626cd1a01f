"""notMIWAE family: MNAR models with a learned missingness process p(s|x)
(port of the JAX package's `models/notmiwae.py`).

Covers:
  notMIWAE_myversion        (reference: src/models/VAE.py:2691-2847) — 'changed'
  notMIWAE                  (reference: src/models/VAE.py:2850-3008) — 'author'
  REG_notMIWAE_v2           (reference: src/models/VAE.py:2327-2505) — 'v2',
      the reg variant the reference's factory instantiates
  REG_notMIWAE              (reference: src/models/VAE.py:2508-2688) — 'both_s':
      both branches get log p(s|x) terms
  REG_notMIWAE_new_version  (reference: src/models/VAE.py:2132-2324) —
      'sampled_mask': mask_p sampled from the learned missingness model

Missingness processes (reference: VAE.py:2778-2787):
  selfmasking:        logits = -W * (x_mixed - b)
  selfmasking_known:  logits = -softplus(W) * (x_mixed - b)   [default]
  linear:             logits = Linear(x_mixed)

As in the JAX package, the bound logsumexps the positive l_w = RE + KL -
log p(s|x) (PARITY.md deviation 3, VAE.py:2803-2807) unless
cfg.fixed_iwae_bound, and one z feeds both the decoder and the KL term.

Where the JAX functions take a PRNG key, these take the noise: `eps`
[B, K, latent_dim] for `forward`, `eval_step` and a vanilla type's
`train_loss`; [2, B, K, latent_dim] (row 0 the q branch, row 1 the p
branch) for a regularized type's; and for the 'sampled_mask' variant
`mask_s`, the uniforms [B, D] of its Bernoulli draw: JAX's
`bernoulli(ks, p)` is `uniform(ks, p.shape) < p`.

`eval_step` runs as one IW2 call (`ops/fused_iw_mnar`: a CUDA kernel on the
card, on the CPU its plain version, this module's eager composition to the
bit): the encoder, the per-sample terms and each row's reductions over K,
wherever it runs without gradients in float32 (`_fused`, the rule
`models/miwae` shares) under the self-masking-known missingness process,
the one every evaluation caller passes: `eval_vae_mnar` and its ensemble,
`eval_vae`, `evaluate_sharded`, `inference.completion` and `serve`. Where
gradients are enabled, `compute_dtype('bfloat16')` is active or another
process is asked for, it runs `_eager_rows` (`forward`, `_branch` and the
reductions over K), as `train_loss` always runs the first two (IW2 has no
backward); AIS calls the layers itself.

Under a torch profiler the eager path records the spans `notmiwae.encode`
(the encoder), `notmiwae.decode` (the reparameterised z and the decoder's
trunk and heads over B*K samples), `notmiwae.likelihood` (RE, log q, log p),
`notmiwae.missingness` (x_mixed, the missingness logits and the Bernoulli
log-pmf of the mask) and `notmiwae.weights` (the logsumexp over K, the
softmax and the imputation), nested in the caller's `model.eval_step` or
`model.train_loss`; IW2's path records only `notmiwae.decode`, around the
one call, which holds all of that work. The counters (`utils/tracing`):
`iw_samples` (rows x K decoded, once a `forward` or an IW2 call) and
`iw_fused_samples` (the same, once an IW2 call).
"""

from __future__ import annotations

import math

import torch

from vae_posterior_consistency_tpu_torch.models import layers
from vae_posterior_consistency_tpu_torch.nn import core
from vae_posterior_consistency_tpu_torch.ops import fused_iw, fused_iw_mnar
from vae_posterior_consistency_tpu_torch.ops.math import (
    bernoulli_logits_logpmf,
    kl_diag_diag,
    normal_logpdf,
    softmax_neg,
    std_normal_logpdf,
)
from vae_posterior_consistency_tpu_torch.utils import tracing


def train_noise(cfg, B, D):
    """The noise a training step draws: {kind: shape}."""
    L, K = cfg.latent_dim, cfg.train_k
    if not cfg.info.regularized:
        return {"eps": (B, K, L)}
    shapes = {"eps": (2, B, K, L)}
    if cfg.reg_notmiwae_variant == "sampled_mask":
        shapes["mask_s"] = (B, D)
    return shapes


def eval_noise(cfg, B, D):
    """The noise an evaluation batch draws: the q branch's only."""
    del D
    return {"eps": (B, cfg.valid_k, cfg.latent_dim)}


def train_noise_rows(cfg):
    """The batch-row axis of each `train_noise` kind."""
    return {"eps": 1 if cfg.info.regularized else 0, "mask_s": 0}


def eval_noise_rows(cfg):
    """The batch-row axis of each `eval_noise` kind."""
    del cfg
    return {"eps": 0}


def init(generator, cfg, obs_dim, device="cuda"):
    return {
        "encoder": layers.notmiwae_encoder_init(generator, obs_dim,
                                                cfg.latent_dim, device),
        "decoder": layers.notmiwae_decoder_init(generator, obs_dim,
                                                cfg.latent_dim, device),
        # the missing process's W, b: xavier_uniform on [1, 1, D]
        # (reference: VAE.py:2735-2740)
        "W": core.xavier_uniform(generator, (1, obs_dim), device)[None],
        "b": core.xavier_uniform(generator, (1, obs_dim), device)[None],
        "logits_lin": core.torch_linear_init(generator, obs_dim, obs_dim,
                                             device),
    }


def encode(params, x, mask, cfg):
    """(mean, logvar) of q(z|x,mask) (reference: VAE.py:2748-2763)."""
    return layers.notmiwae_encoder_apply(params["encoder"], x, mask,
                                         variant=cfg.not_miwae_type)


def forward(params, x, mask, eps, cfg):
    """K samples for noise `eps` [B, K, L]: a dict of [B, K, ...] tensors
    and the [B, L] posterior statistics."""
    with tracing.span("notmiwae.encode"):
        mean, logvar = encode(params, x, mask, cfg)
    with tracing.span("notmiwae.decode"):
        z = mean[:, None, :] + torch.exp(0.5 * logvar)[:, None, :] * eps
        x_mean, x_logvar = layers.notmiwae_decoder_apply(
            params["decoder"], z, variant=cfg.not_miwae_type)
    tracing.count("iw_samples", eps.shape[0] * eps.shape[1])
    return {"mean": mean, "logvar": logvar, "z": z, "x_mean": x_mean,
            "x_logvar": x_logvar}


def missingness_logits(params, x_mixed, missing_process="selfmasking_known"):
    """Bernoulli logits of p(s|x) on the mixed (observed + reconstructed)
    data (reference: VAE.py:2778-2787)."""
    if missing_process == "selfmasking":
        return -params["W"] * (x_mixed - params["b"])
    if missing_process == "selfmasking_known":
        return (-torch.nn.functional.softplus(params["W"])
                * (x_mixed - params["b"]))
    return core.dense(params["logits_lin"], x_mixed)  # 'linear'


def _x_mixed(out, x, m):
    return out["x_mean"] * (1.0 - m) + x[:, None, :] * m


def _branch(params, out, x, mask, missing_process, with_s=True):
    """RE, KL, log p(s|x) and l_w of one branch, all [B, K]."""
    with tracing.span("notmiwae.likelihood"):
        m = mask[:, None, :]
        new_x = x[:, None, :]
        RE = -torch.sum(normal_logpdf(new_x * m, out["x_mean"] * m,
                                      out["x_logvar"] * m), dim=-1)
        # KL = log q(z) - log p(z), Monte Carlo with the decoder's z
        # (the reference redraws z: VAE.py:2791-2798)
        logq = torch.sum(normal_logpdf(out["z"], out["mean"][:, None, :],
                                       out["logvar"][:, None, :]), dim=-1)
        logp = torch.sum(std_normal_logpdf(out["z"]), dim=-1)
        KL = logq - logp
        l_w = RE + KL
        log_p_s = torch.zeros_like(RE)
    if with_s:
        with tracing.span("notmiwae.missingness"):
            logits = missingness_logits(params, _x_mixed(out, x, m),
                                        missing_process)
            log_p_s = torch.sum(bernoulli_logits_logpmf(
                logits, m.expand(logits.shape)), dim=-1)
            l_w = l_w - log_p_s
    return RE, KL, log_p_s, l_w


def _row_bound(l_w, num_samples, fixed=False):
    """Per row: logsumexp_K(l_w) - log K, the reference's objective
    (VAE.py:2805-2807); `fixed` gives the textbook notMIWAE bound."""
    sign = -1.0 if fixed else 1.0
    return sign * (torch.logsumexp(sign * l_w, dim=1)
                   - math.log(num_samples))


def _bound(l_w, num_samples, fixed=False):
    """The batch mean of `_row_bound`."""
    return torch.mean(_row_bound(l_w, num_samples, fixed))


def _impute(l_w, x_mean):
    """Self-normalized importance imputation (reference: VAE.py:2811-2812)."""
    return torch.einsum("bk,bkd->bd", softmax_neg(l_w, dim=1), x_mean)


def train_loss(params, x, mask, mask_p, eps, epoch, cfg, mask_s=None,
               missing_process="selfmasking_known"):
    """The bound; for a regularized type the consistency composite of its
    variant (cfg.reg_notmiwae_variant). Returns (loss, aux). `epoch` is
    unused."""
    del epoch
    K = eps.shape[-2]
    fixed = cfg.fixed_iwae_bound
    if not cfg.info.regularized:
        out_q = forward(params, x, mask, eps, cfg)
        RE_q, _, _, l_w_q = _branch(params, out_q, x, mask, missing_process)
        with tracing.span("notmiwae.weights"):
            loss_q = _bound(l_w_q, K, fixed)
        return loss_q, {"RE_q": torch.mean(RE_q)}

    variant = cfg.reg_notmiwae_variant
    out_q = forward(params, x, mask, eps[0], cfg)
    _, _, _, l_w_q = _branch(params, out_q, x, mask, missing_process)
    with tracing.span("notmiwae.weights"):
        loss_q = _bound(l_w_q, K, fixed)

    if variant == "sampled_mask":
        # REG_notMIWAE_new_version: mask_p drawn from the learned p(s|x) of
        # the q branch's first sample (reference: VAE.py:2232-2239)
        if mask_s is None:
            raise ValueError("train_loss: reg_notmiwae_variant="
                             "'sampled_mask' needs mask_s")
        logits_q = missingness_logits(
            params, _x_mixed(out_q, x, mask[:, None, :]), missing_process)
        s = (mask_s < torch.sigmoid(logits_q[:, 0, :])).to(x.dtype)
        mask_p = s * mask

    with_s_p = variant in ("both_s", "sampled_mask")
    out_p = forward(params, x, mask_p, eps[1], cfg)
    _, _, _, l_w_p = _branch(params, out_p, x, mask_p, missing_process,
                             with_s=with_s_p)
    with tracing.span("notmiwae.weights"):
        loss_p = _bound(l_w_p, K, fixed)

    # the elementwise q/p KL's mean (the reference's `.mean()`, VAE.py:2448)
    B, L = out_q["mean"].shape
    KL_reg = kl_diag_diag(out_q["mean"], out_q["logvar"], out_p["mean"],
                          out_p["logvar"]) / (B * L)
    extra = (mask * (1.0 - mask_p))[:, None, :]
    RE_extra = torch.mean(-torch.sum(normal_logpdf(
        x[:, None, :] * extra, out_q["x_mean"] * extra,
        out_q["x_logvar"] * extra), dim=-1))
    loss = loss_q + cfg.alpha * (KL_reg - loss_q + loss_p + RE_extra)
    return loss, {"loss_q": loss_q, "loss_p": loss_p, "KL_reg": KL_reg}


#: whether `eval_step` runs IW2 (under the default missingness process):
#: IW1's rule, shared with `models/miwae` (patch it here to send this
#: model's steps down the eager path)
_fused = fused_iw.fused_eval


def _eager_rows(params, x, mask, eps, cfg,
                missing_process="selfmasking_known"):
    """(x_imputed [B, D], row_loss [B], row_negl [B], mean, logvar) of the q
    branch from `forward`, `_branch` and the reductions over K: the eager
    composition (training runs its first two) and IW2's plain version."""
    K = eps.shape[-2]
    out_q = forward(params, x, mask, eps, cfg)
    RE_q, _, _, l_w_q = _branch(params, out_q, x, mask, missing_process)
    with tracing.span("notmiwae.weights"):
        row_re = torch.mean(RE_q, dim=1)
        return (_impute(l_w_q, out_q["x_mean"]),
                _row_bound(l_w_q, K, cfg.fixed_iwae_bound), row_re,
                out_q["mean"], out_q["logvar"])


def _fused_rows(params, x, mask, eps, cfg):
    """(x_imputed, row_loss, row_negl) from one IW2 call: the encoder, z,
    the decoder, RE, the KL, the missingness log-pmf and the reductions over
    K (`ops/fused_iw_mnar`)."""
    with tracing.span("notmiwae.decode"):
        x_imputed, per_row, _, _ = fused_iw_mnar.iw_mnar(x, mask, eps,
                                                         params, cfg)
    samples = eps.shape[0] * eps.shape[1]
    tracing.count("iw_samples", samples)
    tracing.count("iw_fused_samples", samples)
    return x_imputed, per_row[0], per_row[1]


def eval_step(params, x, mask, mask_p, eps, cfg,
              missing_process="selfmasking_known"):
    """llh_eval semantics (reference: VAE.py:2458-2461, 2810-2813), per row,
    on the q branch; `mask_p` is unused, as in the JAX package. Without
    gradients in float32 under the self-masking-known process the step is
    one IW2 call (`_fused`)."""
    del mask_p
    if _fused() and missing_process == "selfmasking_known":
        x_imputed, row_loss, row_negl = _fused_rows(params, x, mask, eps,
                                                    cfg)
    else:
        x_imputed, row_loss, row_negl, _, _ = _eager_rows(
            params, x, mask, eps, cfg, missing_process)
    return {"x_imputed": x_imputed, "row_loss": row_loss,
            "row_negl": row_negl, "row_negl_imp": row_negl}

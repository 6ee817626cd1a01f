"""Encoder/decoder building blocks of the model families (port of the JAX
package's `models/layers.py`).

Gauss encoders return (mean, logvar):
- dense       — MLP on x*mask          (reference: src/models/VAE.py:366-372)
- dense_mask  — MLP on [x*mask, mask]  (reference: src/models/VAE.py:526-532)
- pointnet    — EDDI per-feature embed + masked sum-pool + trunk
                                       (reference: src/models/VAE.py:687-741)
The sigmoid decoder has a fixed observation logvar (models/gauss.decode).
The flow's context encoder returns the spline conditioning context; its
decoder (x_mean, x_logvar) with the logvar fixed at FLOW_OBS_LOGVAR.
The importance-weighted families: the MIWAE encoder returns (mean, scale),
its Student-t decoder (mean, scale, df); the notMIWAE encoder returns
(mean, logvar) and its decoder (x_mean, x_logvar), each in the `changed`
or the `author` variant.
"""

from __future__ import annotations

import torch

from vae_posterior_consistency_tpu_torch.nn import core
from vae_posterior_consistency_tpu_torch.ops import fused_embed_pool
from vae_posterior_consistency_tpu_torch.ops.math import student_t_head


def dense_encoder_init(generator, obs_dim, latent_dim, widths=(100, 50),
                       device="cuda"):
    return core.mlp_init(generator, [obs_dim, *widths, 2 * latent_dim], device)


def dense_encoder_apply(params, x, mask):
    h = core.mlp_apply(params, x * mask, hidden_act="relu")
    mean, logvar = h.chunk(2, dim=-1)
    return mean, logvar


def dense_mask_encoder_init(generator, obs_dim, latent_dim, widths=(100, 50),
                            device="cuda"):
    return core.mlp_init(generator, [2 * obs_dim, *widths, 2 * latent_dim],
                         device)


def dense_mask_encoder_apply(params, x, mask):
    h = core.mlp_apply(params, torch.cat([x * mask, mask], dim=-1),
                       hidden_act="relu")
    mean, logvar = h.chunk(2, dim=-1)
    return mean, logvar


def pointnet_encoder_init(generator, obs_dim, latent_dim, emb_dim,
                          trunk_widths=(100, 50), device="cuda"):
    """EDDI/PointNet encoder. `trunk_widths=(500,500,200)` for the MNIST
    variant (reference: src/models/VAE.py:32-40 vs 692-698)."""
    return {
        "pnp1": core.mlp_init(generator, [2 + emb_dim, emb_dim], device),
        "pnp2": core.mlp_init(generator,
                              [emb_dim, *trunk_widths, 2 * latent_dim], device),
        "type_pars": core.xavier_uniform(generator, (obs_dim, emb_dim), device),
        "type_bias": core.xavier_uniform(generator, (obs_dim, 1), device),
    }


def pointnet_encoder_apply(params, x, mask):
    """Per-feature embed [x_d, x_d*W_d, b_d] -> Linear+ReLU -> masked sum-pool
    -> trunk (reference: src/models/VAE.py:719-741), with the per-feature
    Linear collapsed to relu(x_d * A_d + C_d) (see _pointnet_affine)."""
    agg = _pointnet_pool(params, x, mask)
    h = core.mlp_apply(params["pnp2"], agg, hidden_act="relu")
    mean, logvar = h.chunk(2, dim=-1)
    return mean, logvar


def _pointnet_affine(params):
    """The collapsed embed's batch-independent affine (A, C), both [D, K]:
    the embedding features are linear in x_d, so the per-feature Linear
    W1 [K+2, K], b1 [K] collapses to A = W1[0] + type_pars @ W1[1:K+1] and
    C = type_bias * W1[K+1] + b1."""
    W1 = params["pnp1"]["layer0"]["w"]  # [K+2, K]
    b1 = params["pnp1"]["layer0"]["b"]  # [K]
    A = W1[0] + params["type_pars"] @ W1[1:-1]
    C = params["type_bias"] * W1[-1] + b1
    return A, C


def _pointnet_pool_multi(params, x, masks):
    """Pool the mask-independent embedding under a stack of masks
    [S, B, D] -> [S, B, K], through the fused embed+pool kernel on CUDA
    tensors (its plain version on CPU tensors).

    Under compute_dtype('bfloat16') a CPU tensor's [B, D, K] embed is held
    in bf16, each op rounded as the JAX package's plain path rounds it
    (`layers.py:93-108`; bit for bit on the CPU), and pooled in float32.
    On the card the kernels stay float32, as the JAX package's Pallas path
    does under bf16 (`layers.py:127-132`): B2f never stores the embed, so
    there is nothing to narrow (ROADMAP C.4.32)."""
    if core.active_dtype() == "bfloat16" and x.device.type == "cpu":
        return torch.einsum("...sbd,...bdk->...sbk", masks,
                            _pointnet_embed_bf16(params, x).float())
    A, C = _pointnet_affine(params)
    return fused_embed_pool.embed_pool(x, masks, A, C)


def _pointnet_embed_bf16(params, x):
    """The collapsed embed relu(x_d * A_d + C_d) [..., B, D, K] held in
    bf16, each op rounded (the JAX package's `_pointnet_embed` under
    compute_dtype('bfloat16'))."""
    A, C = _pointnet_affine(params)
    bf16 = torch.bfloat16
    return torch.relu(x[..., None].to(bf16) * A.to(bf16).unsqueeze(-3)
                      + C.to(bf16).unsqueeze(-3))


def _pointnet_pool(params, x, mask):
    return _pointnet_pool_multi(params, x, mask[None])[0]  # [B, K]


def pointnet_encoder_apply_2masks(params, x, mask_q, mask_p):
    """Both posterior branches of a regularized EDDI model in one pass: the
    embed does not depend on the mask, so it is pooled under
    stack([mask_q, mask_p]) in one call (the fused kernel at S=2 on CUDA
    tensors, its backward in training), and the trunk runs on the stacked
    [2, B, K] aggregate. Returns (mean, logvar) shaped [2, B, L], row 0 the
    q branch and row 1 the p branch."""
    agg = _pointnet_pool_multi(params, x, torch.stack([mask_q, mask_p]))
    h = core.mlp_apply(params["pnp2"], agg, hidden_act="relu")
    mean, logvar = h.chunk(2, dim=-1)
    return mean, logvar


def miwae_encoder_init(generator, obs_dim, latent_dim, device="cuda"):
    return core.mlp_init(generator, [obs_dim, 128, 128, 2 * latent_dim],
                         device)


def miwae_encoder_apply(params, x, mask):
    """(mean, scale), a softplus scale (reference: VAE.py:3047-3059)."""
    h = core.mlp_apply(params, x * mask, hidden_act="relu")
    mean, pre_scale = h.chunk(2, dim=-1)
    return mean, torch.nn.functional.softplus(pre_scale)


def notmiwae_encoder_init(generator, obs_dim, latent_dim, device="cuda"):
    return {
        "trunk": core.mlp_init(generator, [obs_dim, 128, 128], device),
        "q_mu": core.mlp_init(generator, [128, latent_dim], device),
        "q_logstd": core.mlp_init(generator, [128, latent_dim], device),
    }


def notmiwae_encoder_apply(params, x, mask, variant="changed"):
    """(mean, logvar). `changed`: ELU trunk, no clipping (reference:
    VAE.py:2748-2763); `author`: Tanh trunk, hardtanh(-10, 10) on the
    log-std head (reference: VAE.py:2865-2922)."""
    act = "elu" if variant == "changed" else "tanh"
    h = core.mlp_apply(params["trunk"], x * mask, hidden_act=act,
                       final_act=act)
    mean = core.dense(params["q_mu"]["layer0"], h)
    logvar = core.dense(params["q_logstd"]["layer0"], h)
    if variant == "author":
        logvar = core.hardtanh(logvar, -10.0, 10.0)
    return mean, logvar


def flow_context_encoder_init(generator, obs_dim, hid_dim, context_dim=100,
                              device="cuda"):
    return core.mlp_init(generator, [2 * obs_dim, hid_dim, hid_dim,
                                     context_dim], device)


def flow_context_encoder_apply(params, x, mask):
    """ELU trunk over [x*mask, mask] -> spline conditioning context
    (reference: src/models/VAE.py:1882-1890, 1924-1926)."""
    return core.mlp_apply(params, torch.cat([x * mask, mask], dim=-1),
                          hidden_act="elu")


def sigmoid_decoder_init(generator, obs_dim, latent_dim, widths=(50, 100),
                         device="cuda"):
    """`widths=(200,500,500)` for the MNIST variant (reference: VAE.py:41-44)."""
    return core.mlp_init(generator, [latent_dim, *widths, obs_dim], device)


def sigmoid_decoder_apply(params, z):
    return core.mlp_apply(params, z, hidden_act="relu", final_act="sigmoid")


def notmiwae_decoder_init(generator, obs_dim, latent_dim, device="cuda"):
    return {
        "trunk": core.mlp_init(generator, [latent_dim, 128, 128], device),
        "x_mean": core.mlp_init(generator, [128, obs_dim], device),
        "x_logvar": core.mlp_init(generator, [128, obs_dim], device),
    }


def notmiwae_decoder_apply(params, z, variant="changed"):
    """(x_mean, x_logvar). `changed`: ELU trunk, sigmoid mean,
    hardtanh(-10, 0) logvar (reference: VAE.py:2726-2770); `author`: Tanh
    trunk, linear mean, a softplus std with logvar = log(std^2)
    (reference: VAE.py:2885-2928)."""
    if variant == "changed":
        h = core.mlp_apply(params["trunk"], z, hidden_act="elu",
                           final_act="elu")
        x_mean = torch.sigmoid(core.dense(params["x_mean"]["layer0"], h))
        x_logvar = core.hardtanh(core.dense(params["x_logvar"]["layer0"], h),
                                 -10.0, 0.0)
    else:
        h = core.mlp_apply(params["trunk"], z, hidden_act="tanh",
                           final_act="tanh")
        x_mean = core.dense(params["x_mean"]["layer0"], h)
        x_std = torch.nn.functional.softplus(
            core.dense(params["x_logvar"]["layer0"], h))
        x_logvar = torch.log(torch.square(x_std))
    return x_mean, x_logvar


def student_t_decoder_init(generator, obs_dim, latent_dim, device="cuda"):
    return core.mlp_init(generator, [latent_dim, 128, 128, 3 * obs_dim],
                         device)


def student_t_decoder_apply(params, z):
    """(mean, scale, df): a sigmoid mean, softplus + 0.001 scale and
    softplus + 3 degrees of freedom (`ops/math.student_t_head`)."""
    return student_t_head(core.mlp_apply(params, z, hidden_act="relu"))


def flow_decoder_init(generator, obs_dim, latent_dim, hid_dim, device="cuda"):
    return {
        "trunk": core.mlp_init(generator, [latent_dim, hid_dim, hid_dim,
                                           hid_dim, hid_dim], device),
        "mean": core.mlp_init(generator, [hid_dim, obs_dim], device),
        "logvar": core.mlp_init(generator, [hid_dim, obs_dim], device),
    }


#: fixed flow-decoder observation logvar (reference: src/models/VAE.py:1874)
FLOW_OBS_LOGVAR = -8.0


def flow_decoder_apply(params, z):
    """(x_mean, x_logvar): an ELU trunk and a sigmoid mean head; the logvar
    is FLOW_OBS_LOGVAR in every cell, as the reference runs it. The logvar
    head, whose output that constant replaces, is not computed: its
    parameters stay in the model (and the checkpoint) and get no gradient,
    as in the JAX package."""
    h = core.mlp_apply(params["trunk"], z, hidden_act="elu", final_act="elu")
    x_mean = torch.sigmoid(core.dense(params["mean"]["layer0"], h))
    return x_mean, torch.full_like(x_mean, FLOW_OBS_LOGVAR)

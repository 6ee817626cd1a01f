"""Encoder/decoder building blocks of the gauss family (port of the JAX
package's `models/layers.py`, the dense, PointNet and sigmoid-decoder parts).

Encoders return (mean, logvar):
- dense       — MLP on x*mask          (reference: src/models/VAE.py:366-372)
- dense_mask  — MLP on [x*mask, mask]  (reference: src/models/VAE.py:526-532)
- pointnet    — EDDI per-feature embed + masked sum-pool + trunk
                                       (reference: src/models/VAE.py:687-741)
The sigmoid decoder has a fixed observation logvar (models/gauss.decode).
"""

from __future__ import annotations

import torch

from vae_posterior_consistency_tpu_torch.nn import core
from vae_posterior_consistency_tpu_torch.ops import fused_embed_pool


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
    tensors (its plain version on CPU tensors)."""
    A, C = _pointnet_affine(params)
    return fused_embed_pool.embed_pool(x, masks, A, C)


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


def sigmoid_decoder_init(generator, obs_dim, latent_dim, widths=(50, 100),
                         device="cuda"):
    """`widths=(200,500,500)` for the MNIST variant (reference: VAE.py:41-44)."""
    return core.mlp_init(generator, [latent_dim, *widths, obs_dim], device)


def sigmoid_decoder_apply(params, z):
    return core.mlp_apply(params, z, hidden_act="relu", final_act="sigmoid")

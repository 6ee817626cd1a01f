"""Plain PyTorch reference of MIWAE's importance-weighted evaluation
(`vanilla_MIWAE*`): the model and `llh_eval`'s per-batch statistics,
written from the published description and nothing of the system under
test.

The model (Mattei and Frellsen, "MIWAE: Deep Generative Modelling and
Imputation of Incomplete Data Sets", ICML 2019, arXiv:1812.02633; the
posterior-consistency reference `stschia/VAE-posterior-consistency`,
src/models/VAE.py, class MIWAE, 3011-3134):
- the encoder is a ReLU MLP over the zero-filled row x * mask, D -> 128
  -> 128 -> 2 L: (mu, a), and q(z | x) = N(mu, softplus(a)^2) per latent;
- z_k = mu + softplus(a) * eps_k for K standard normal draws eps_k;
- the decoder is a ReLU MLP L -> 128 -> 128 -> 3 D: (m, s, n), and
  p(x_d | z) is a Student-t with location sigmoid(m), scale softplus(s) +
  0.001 and softplus(n) + 3 degrees of freedom;
- log w_k = sum over observed d of log p(x_d | z_k) + log p(z_k) - log
  q(z_k | x), with p(z) = N(0, I);
- the row's bound is logsumexp_k log w_k, its loss the negative;
- the imputation of a row is sum_k softmax_k(log w) E[x | z_k], the
  weights' average of the decoder's locations.
The densities are torch.distributions' Normal and StudentT.

Departures from the published MIWAE that the repository keeps (its
PARITY.md, deviation 2), each followed here:
- one z_k feeds both the decoder and the weights (the reference class
  draws z again for log p(z) - log q(z));
- the [B, K] axes stay aligned, row b's K samples are row b's (the
  reference's reshape round trip scrambles them where K != B);
- the bound has no -log K;
- a vanilla type's `negl` (and `negl_imp`, the same number) is the sum
  over k of the log-density of the missing cells, over the hard-coded 5000
  of the reference (VAE.py:3099), whatever K is.

Everything is float32. Every matrix product, the imputation's weighted sum
too, goes through `matmul`, which rounds both operands to TF32 under
`precision("tf32")`: the control that the comparison must reject. A batch
of rows is taken `BLOCK_SAMPLES` decoder samples at a time (whole rows):
64 rows at K=5000 are 320,000 samples, and each block's [samples, 128]
activations are 16 MB.

`evaluate_split` reads rows of NaN where the draws' sample axis is not the
configuration's `valid_k`: a program that scored fewer (or more)
importance samples than the configuration states can never agree.

Parameters are a flat dict {"encoder/layer0/w": tensor, ...}: the
benchmark makes them (`harness/inputs.py`) and hands the same values to
the system and to this file.
"""

from __future__ import annotations

import contextlib
import math

import torch

#: the reference's hard-coded divisor of a vanilla type's negl
#: (src/models/VAE.py:3099)
NEGL_DIVISOR = 5000.0
#: decoder samples a block takes at most
BLOCK_SAMPLES = 1 << 15

_PRECISION = ["fp32"]


@contextlib.contextmanager
def precision(mode: str):
    """'fp32' (the reference) or 'tf32' (both operands of every product
    rounded to TF32's 10 mantissa bits, float32 sums: the control)."""
    _PRECISION.append(mode)
    try:
        yield
    finally:
        _PRECISION.pop()


def tf32_round(t):
    """Round float32 to the nearest TF32 value (10 mantissa bits), ties
    away from zero, as the tensor cores take their operands."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def matmul(a, b):
    if _PRECISION[-1] == "tf32":
        return torch.matmul(tf32_round(a), tf32_round(b))
    return torch.matmul(a, b)


def param_specs(cfg: dict):
    """[(key, shape, init bound)] of the model in `cfg`, in a fixed order:
    torch's Linear default, U(+-1/sqrt(fan_in)) for weight and bias."""
    D, L = cfg["obs_dim"], cfg["latent_dim"]
    specs = []

    def mlp(prefix, sizes):
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            bound = 1.0 / math.sqrt(a)
            specs.append((f"{prefix}/layer{i}/w", (a, b), bound))
            specs.append((f"{prefix}/layer{i}/b", (b,), bound))

    mlp("encoder", [D, *cfg["encoder_trunk"], 2 * L])
    mlp("decoder", [L, *cfg["decoder"], 3 * D])
    return specs


def _mlp(p, prefix, h):
    """ReLU between the layers, none on the output."""
    n = sum(1 for k in p if k.startswith(prefix + "/layer") and
            k.endswith("/w"))
    for i in range(n):
        h = matmul(h, p[f"{prefix}/layer{i}/w"]) + p[f"{prefix}/layer{i}/b"]
        if i < n - 1:
            h = torch.relu(h)
    return h


def _normal(loc, scale):
    return torch.distributions.Normal(loc, scale, validate_args=False)


def _rows(p, x, mask, eps):
    """Rows x, mask [n, D], eps [n, K, L] -> (row loss [n], row negl [n],
    imputation [n, D])."""
    D = x.shape[-1]
    h = _mlp(p, "encoder", x * mask)
    L = h.shape[-1] // 2
    mu = h[:, :L]
    sigma = torch.nn.functional.softplus(h[:, L:])
    z = mu[:, None, :] + sigma[:, None, :] * eps  # [n, K, L]
    out = _mlp(p, "decoder", z)  # [n, K, 3D]
    loc = torch.sigmoid(out[..., :D])
    scale = torch.nn.functional.softplus(out[..., D:2 * D]) + 0.001
    df = torch.nn.functional.softplus(out[..., 2 * D:]) + 3.0
    logp_x = torch.distributions.StudentT(
        df, loc, scale, validate_args=False).log_prob(x[:, None, :])
    observed = mask[:, None, :]
    log_w = ((logp_x * observed).sum(-1)
             + _normal(0.0, 1.0).log_prob(z).sum(-1)
             - _normal(mu[:, None, :], sigma[:, None, :]).log_prob(z).sum(-1))
    w = torch.softmax(log_w, dim=-1)  # [n, K]
    imputed = matmul(w[:, None, :], loc)[:, 0, :]
    negl = (logp_x * (1.0 - observed)).sum(-1).sum(-1) / NEGL_DIVISOR
    return -torch.logsumexp(log_w, dim=-1), negl, imputed


@torch.no_grad()
def eval_rows(p, cfg, x, mask, eps):
    """Per-row evaluation: {x_imputed, loss, negl, negl_imp}, rows in
    blocks of at most BLOCK_SAMPLES decoder samples."""
    K = eps.shape[-2]
    rows = max(1, BLOCK_SAMPLES // K)
    parts = [_rows(p, x[s:s + rows], mask[s:s + rows], eps[s:s + rows])
             for s in range(0, x.shape[0], rows)]
    loss, negl, imputed = (torch.cat(t) for t in zip(*parts))
    return {"x_imputed": imputed, "loss": loss, "negl": negl,
            "negl_imp": negl}


@torch.no_grad()
def evaluate_split(p, cfg, x, mask, perm, eps, batch):
    """One split at one Monte-Carlo rep: (statistics [batches, 4] (rmse,
    loss, negl, negl_imp of each batch), the imputations [batches * batch,
    D]): rows in the order `perm` (wrap-padded to whole batches), batches
    of `batch` rows, eps [batches * batch, K, L]; a batch's RMSE over the
    missing cells of its real rows, its means over its real rows. The
    split's metrics are the mean over the batches. NaN throughout where K
    is not cfg["valid_k"]."""
    n = x.shape[0]
    steps = -(-n // batch)
    order = torch.cat([perm, perm[:steps * batch - n]])
    xo, mo = x[order], mask[order]
    r = eval_rows(p, cfg, xo, mo, eps)
    w = (torch.arange(steps * batch, device=x.device) < n).float()
    hole = (1.0 - mo) * w[:, None]
    se = torch.square((r["x_imputed"] - xo) * hole).sum(-1)
    per = lambda t: t.reshape(steps, batch).sum(-1)  # noqa: E731
    cnt = per(w)
    rmse = torch.sqrt(per(se) / torch.clamp(per(hole.sum(-1)), min=1.0))
    stats = torch.stack([rmse] + [per(r[k] * w) / cnt for k in
                                  ("loss", "negl", "negl_imp")], dim=1)
    if eps.shape[-2] != cfg["valid_k"]:
        stats = torch.full_like(stats, math.nan)
    return stats, r["x_imputed"]

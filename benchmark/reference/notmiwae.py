"""Plain PyTorch reference of not-MIWAE's MNAR evaluation (`reg_notMIWAE*`
and `vanilla_notMIWAE*` score the same way): the model, its importance
weights under the missingness model, the imputation and the RMSE over the
holes, written from the published description and nothing of the system
under test.

The model (Ipsen, Mattei and Frellsen, "not-MIWAE: Deep Generative
Modelling with Missing not at Random Data", ICLR 2021, arXiv:2006.12871;
the posterior-consistency reference `stschia/VAE-posterior-consistency`,
src/models/VAE.py, `notMIWAE_myversion` 2691-2847 and `REG_notMIWAE_v2`
2327-2505, whose evaluation runs the q branch alone):
- the encoder is an MLP over the zero-filled row x * s (s the mask, 1 =
  observed), D -> 128 -> 128 with an activation after each layer, and two
  linear heads 128 -> L: mu and the log-variance of q(z | x_o) =
  N(mu, exp(logvar));
- z_k = mu + exp(logvar / 2) * eps_k for K standard normal draws eps_k;
- the decoder is an MLP L -> 128 -> 128, an activation after each layer,
  and two heads 128 -> D: the mean and the log-variance of the Gaussian
  p(x_d | z);
- the missingness model p(s | x) is a Bernoulli per feature whose logits
  read the mixed row x_mixed = s * x + (1 - s) * E[x | z_k] (the observed
  cells and the decoder's mean in the holes): the self-masking logits
  -softplus(W) (x_mixed - b) (the configuration's 'selfmasking_known',
  the paper's self-masking with known sign; the program's other two
  processes are not written here);
- log w_k = log p(x_o | z_k) + log p(s | x_mixed) + log p(z_k)
  - log q(z_k | x_o), with p(z) = N(0, I);
- the imputation of a row is sum_k softmax_k(log w) E[x | z_k];
- a rep's RMSE is sqrt(sum over the holes of (imputation - x)^2 / number
  of holes), over the whole matrix.
The densities are torch.distributions' Normal and Bernoulli.

The activations ('changed', `notMIWAE_myversion`, the factory's default):
ELU after each trunk layer, a sigmoid on the decoder's mean, the
decoder's log-variance clamped to [-10, 0] (hardtanh), none on the
encoder's heads. 'author' (`notMIWAE`, VAE.py:2850-3008): Tanh trunks, the
encoder's log-variance head clamped to [-10, 10], a linear decoder mean
and a softplus decoder std, log-variance log(std^2).

Departures from the published not-MIWAE that the repository keeps, each
followed here:
- the row's bound is logsumexp_k(l_w) - log K of the positive l_w = -log
  w_k (its PARITY.md, deviation 3; VAE.py:2803-2807), not the paper's
  logsumexp_k(log w_k) - log K; the weights are softmax(-l_w), the
  paper's;
- one z_k feeds both the decoder and log p(z) - log q(z) (the reference
  class draws z again for the KL);
- the observed likelihood is the density of the masked row: Normal(x * s;
  mean * s, exp(logvar * s)) summed over all D cells, so each hole adds
  log N(0; 0, 1) to log w. A constant of the row: the weights, the
  imputation and the RMSE do not see it; the bound does;
- `row_negl` is the mean over k of -log p(x_o | z_k) in that form.

Everything is float32. Every matrix product, the imputation's weighted sum
too, goes through `matmul`, which rounds both operands to TF32 under
`precision("tf32")`: the control that the comparison must reject. The
samples are taken `BLOCK_SAMPLES` at a time in blocks of K for all rows
(178 rows at K=10,000 are 1.78 M samples); each block's l_w and decoder
mean are kept, and the reductions over K run once at the end.

`evaluate` reads NaN where the draws' sample axis is not the
configuration's `valid_k`: a program that scored fewer (or more)
importance samples than the configuration states can never agree.

Parameters are a flat dict {"encoder/trunk/layer0/w": tensor, ...}: the
benchmark makes them (`harness/inputs.py`) and hands the same values to
the system and to this file.
"""

from __future__ import annotations

import contextlib
import math

import torch

#: decoder samples a block takes at most
BLOCK_SAMPLES = 1 << 18

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
    torch's Linear default, U(+-1/sqrt(fan_in)) for weight and bias; the
    self-masking W and b [1, 1, D] xavier-uniform, U(+-sqrt(6 / (1 +
    D)))."""
    D, L = cfg["obs_dim"], cfg["latent_dim"]
    specs = []

    def linear(prefix, a, b):
        bound = 1.0 / math.sqrt(a)
        specs.append((f"{prefix}/w", (a, b), bound))
        specs.append((f"{prefix}/b", (b,), bound))

    def mlp(prefix, sizes):
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            linear(f"{prefix}/layer{i}", a, b)

    enc, dec = cfg["encoder_trunk"], cfg["decoder_trunk"]
    mlp("encoder/trunk", [D, *enc])
    linear("encoder/q_mu/layer0", enc[-1], L)
    linear("encoder/q_logstd/layer0", enc[-1], L)
    mlp("decoder/trunk", [L, *dec])
    linear("decoder/x_mean/layer0", dec[-1], D)
    linear("decoder/x_logvar/layer0", dec[-1], D)
    xavier = math.sqrt(6.0 / (1 + D))
    return specs + [("W", (1, 1, D), xavier), ("b", (1, 1, D), xavier)]


def _linear(p, prefix, h):
    return matmul(h, p[f"{prefix}/w"]) + p[f"{prefix}/b"]


def _trunk(p, prefix, h, act):
    n = sum(1 for k in p if k.startswith(prefix + "/layer") and
            k.endswith("/w"))
    for i in range(n):
        h = act(_linear(p, f"{prefix}/layer{i}", h))
    return h


def _activation(cfg):
    return (torch.nn.functional.elu if cfg["not_miwae_type"] == "changed"
            else torch.tanh)


def encode(p, cfg, x, mask):
    """(mu, logvar) [n, L] of q(z | x_o)."""
    h = _trunk(p, "encoder/trunk", x * mask, _activation(cfg))
    mu = _linear(p, "encoder/q_mu/layer0", h)
    logvar = _linear(p, "encoder/q_logstd/layer0", h)
    if cfg["not_miwae_type"] == "author":
        logvar = torch.clamp(logvar, -10.0, 10.0)
    return mu, logvar


def decode(p, cfg, z):
    """(mean, logvar) [..., D] of p(x | z)."""
    h = _trunk(p, "decoder/trunk", z, _activation(cfg))
    if cfg["not_miwae_type"] == "changed":
        mean = torch.sigmoid(_linear(p, "decoder/x_mean/layer0", h))
        logvar = torch.clamp(_linear(p, "decoder/x_logvar/layer0", h),
                             -10.0, 0.0)
    else:
        mean = _linear(p, "decoder/x_mean/layer0", h)
        std = torch.nn.functional.softplus(
            _linear(p, "decoder/x_logvar/layer0", h))
        logvar = torch.log(torch.square(std))
    return mean, logvar


def missingness_logits(p, cfg, x_mixed):
    """The Bernoulli logits of p(s | x) on the mixed rows."""
    if cfg["missing_process"] != "selfmasking_known":
        raise ValueError(f"missing_process {cfg['missing_process']!r}: "
                         "only 'selfmasking_known' is written here")
    return -torch.nn.functional.softplus(p["W"]) * (x_mixed - p["b"])


def _normal(loc, logvar):
    return torch.distributions.Normal(loc, torch.exp(0.5 * logvar),
                                      validate_args=False)


def _block(p, cfg, x, mask, mu, logvar, eps, with_s=True):
    """Samples eps [n, k, L] -> (l_w [n, k], -log p(x_o | z) [n, k],
    decoder mean [n, k, D])."""
    z = mu[:, None, :] + torch.exp(0.5 * logvar)[:, None, :] * eps
    mean, x_logvar = decode(p, cfg, z)
    s = mask[:, None, :]
    re = -_normal(mean * s, x_logvar * s).log_prob(x[:, None, :] * s).sum(-1)
    log_q = _normal(mu[:, None, :], logvar[:, None, :]).log_prob(z).sum(-1)
    log_pz = _normal(torch.zeros_like(z), torch.zeros_like(z)).log_prob(
        z).sum(-1)
    l_w = re + log_q - log_pz
    if with_s:
        x_mixed = mean * (1.0 - s) + x[:, None, :] * s
        log_ps = torch.distributions.Bernoulli(
            logits=missingness_logits(p, cfg, x_mixed),
            validate_args=False).log_prob(s.expand_as(mean)).sum(-1)
        l_w = l_w - log_ps
    return l_w, re, mean


@torch.no_grad()
def eval_rows(p, cfg, x, mask, eps, with_s=True):
    """Per row over eps [n, K, L]: {x_imputed [n, D], loss (the bound),
    negl}; the samples in blocks of K of at most BLOCK_SAMPLES for all
    rows. `with_s=False` leaves log p(s | x) out of the weights (what
    the MIWAE under MAR would score)."""
    n, K = eps.shape[0], eps.shape[1]
    mu, logvar = encode(p, cfg, x, mask)
    step = max(1, BLOCK_SAMPLES // n)
    parts = [_block(p, cfg, x, mask, mu, logvar, eps[:, k:k + step], with_s)
             for k in range(0, K, step)]
    l_w, re, mean = (torch.cat(t, dim=1) for t in zip(*parts))
    w = torch.softmax(-l_w, dim=1)  # [n, K]
    imputed = matmul(w[:, None, :], mean)[:, 0, :]
    return {"x_imputed": imputed,
            "loss": torch.logsumexp(l_w, dim=1) - math.log(K),
            "negl": re.mean(1)}


@torch.no_grad()
def evaluate(p, cfg, x, mask, eps, with_s=True):
    """One MNAR rep over the whole matrix: {rmse (0-d), x_imputed, loss,
    negl}; the RMSE over all the holes. NaN throughout where K is not
    cfg["valid_k"]."""
    r = eval_rows(p, cfg, x, mask, eps, with_s)
    hole = 1.0 - mask
    se = torch.square((r["x_imputed"] - x) * hole).sum()
    r["rmse"] = torch.sqrt(se / hole.sum())
    if eps.shape[1] != cfg["valid_k"]:
        r = {k: torch.full_like(v, math.nan) for k, v in r.items()}
    return r

"""Plain PyTorch reference of the flow-posterior VAE's evaluation
(`reg_flow*` and `vanilla_flow*` score the same way): the context encoder,
the conditional piecewise-linear spline flow, the decoder and `llh_eval`'s
per-batch statistics, written from the published description and nothing
of the system under test.

The model (the posterior-consistency reference
`stschia/VAE-posterior-consistency`, src/models/VAE.py: `VAEFlow`
1860-1980, `REG_VAEFlow` 1983-2124, whose evaluation runs the q branch
alone; the flow `Flow` 1816-1857 over `PiecewiseLinearCDF` 1781-1813 and
`unconstrained_linear_spline` / `linear_spline` 1680-1774, the
piecewise-linear coupling of Mueller et al., "Neural Importance Sampling",
arXiv:1808.03856):
- the context encoder is an ELU MLP over [x * mask, mask], 2 D -> 500 ->
  500 -> L * L, read as bin logits [L dims, L bins];
- the flow pushes a standard normal eps [L] through three spline layers
  that share those logits. A layer maps [-1, 1] onto [-1, 1]: u = (x +
  1) / 2, the bin of u * L, its cdf from the softmax of the logits
  (cumsum, the top edge exactly 1, a 0 prepended); the output is cdf_left
  + alpha * pdf of that bin, clipped to [0, 1], mapped back to [-1, 1];
  its log |det| is log(pdf of the bin) - log(1 / L);
- log q(z) = log N(eps; 0, I) - the sum of the three log |det|s;
- the decoder is an ELU MLP L -> 500 -> 500 -> 500 -> 500, an ELU on its
  last layer too, and a sigmoid mean head 500 -> D; the observation
  log-variance is the fixed -8 (VAE.py:1874; the logvar head is built but
  its output is not used);
- a row's RE is -sum over the D cells of log N(x * m; mean * m, exp(-8 *
  m)), the reference's mask-everything form (VAE.py:1955-1956), so each
  hidden cell adds log N(0; 0, 1); RE_imp the same under 1 - m; KL is
  sum over the latents of log q(z) - log N(z; 0, I); the loss is RE + KL;
  the imputation is the decoder's mean.
The densities are torch.distributions' Normal.

Departures from the reference code that the repository keeps (its
PARITY.md), each followed here:
- the clamp tails (deviation 5): an input outside [-1, 1] is replaced by
  0 and spline-mapped like the rest (the reference's effective behaviour
  of its outside-interval overwrite, VAE.py:1689-1707); the bin-logit
  masking pun of VAE.py:1695-1696 is not reproduced;
- `log_prob`, the inverse pass, adds the inverse log |det|s to log N of
  the pulled-back point (deviation 1: the reference's `Flow.backward`
  subtracts them, VAE.py:1857), so that it agrees with the log q the
  forward pass gives. Evaluation does not read it.

The bin search is a `floor`, so a value that rounds to the other side of a
bin edge takes another bin, whose log |det| differs by O(1): a reference
whose bin logits round otherwise than the program's would differ from it
by whole bins, about once in 10^6 spline inputs. Everything that decides
a bin is therefore the equations' own float32 operations in their written
order, batch by batch at the program's batch shapes: each product a
`torch.matmul` and then its bias added, the softmax, the cumsum, (x + 1) /
2 * L, alpha * pdf added to cdf_left. The densities, the sums and the
means are computed their own way.

Everything is float32, TF32 off. Every matrix product goes through
`matmul`, which rounds both operands to TF32 under `precision("tf32")`:
the control that the comparison must reject.

Parameters are a flat dict {"encoder/layer0/w": tensor, ...}: the
benchmark makes them (`harness/inputs.py`) and hands the same values to
the system and to this file.
"""

from __future__ import annotations

import contextlib
import math

import torch

#: spline layers of the reference's `Flow` (VAE.py:1816-1827)
LAYERS = 3
#: the decoder's fixed observation log-variance (VAE.py:1874)
OBS_LOGVAR = -8.0

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


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def param_specs(cfg: dict):
    """[(key, shape, init bound)] of the model in `cfg`, in a fixed order:
    torch's Linear default, U(+-1/sqrt(fan_in)) for weight and bias. The
    decoder's logvar head is made, as the reference builds it, and not
    read."""
    D, L = cfg["obs_dim"], cfg["latent_dim"]
    specs = []

    def linear(prefix, a, b):
        bound = 1.0 / math.sqrt(a)
        specs.append((f"{prefix}/w", (a, b), bound))
        specs.append((f"{prefix}/b", (b,), bound))

    def mlp(prefix, sizes):
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            linear(f"{prefix}/layer{i}", a, b)

    mlp("encoder", [2 * D, *cfg["encoder_trunk"], L * L])
    dec = [L, *cfg["decoder"]]
    mlp("decoder/trunk", dec)
    linear("decoder/mean/layer0", dec[-1], D)
    linear("decoder/logvar/layer0", dec[-1], D)
    return specs


def _linear(p, prefix, h):
    return matmul(h, p[f"{prefix}/w"]) + p[f"{prefix}/b"]


def _layers(p, prefix):
    return sum(1 for k in p if k.startswith(prefix + "/layer") and
               k.endswith("/w"))


def context(p, x, mask):
    """Bin logits [n, L, L] of rows x, mask [n, D]."""
    h = torch.cat([x * mask, mask], dim=-1)
    n = _layers(p, "encoder")
    for i in range(n):
        h = _linear(p, f"encoder/layer{i}", h)
        if i < n - 1:
            h = torch.nn.functional.elu(h)
    L = math.isqrt(h.shape[-1])
    return h.reshape(*h.shape[:-1], L, L)


def decode(p, z):
    """The decoder's mean [..., D]."""
    h = z
    for i in range(_layers(p, "decoder/trunk")):
        h = torch.nn.functional.elu(_linear(p, f"decoder/trunk/layer{i}", h))
    return torch.sigmoid(_linear(p, "decoder/mean/layer0", h))


def _cdf(logits):
    """(pdf [..., bins], cdf [..., bins + 1]): the softmax, its cumsum with
    the top edge set to exactly 1 and a 0 prepended (VAE.py:1726-1731)."""
    pdf = torch.softmax(logits, dim=-1)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf[..., -1] = 1.0
    return pdf, torch.nn.functional.pad(cdf, (1, 0), value=0.0)


def _inside(x):
    """The clamp tails: a value outside [-1, 1] becomes 0."""
    return torch.where((x >= -1.0) & (x <= 1.0), x, torch.zeros_like(x))


def spline(x, logits):
    """One forward layer (VAE.py:1754-1774): x [..., L] -> (y, log |det|)."""
    bins = logits.shape[-1]
    u = (_inside(x) + 1.0) / 2.0
    pdf, cdf = _cdf(logits)
    pos = u * bins
    idx = torch.clamp(torch.floor(pos).long(), max=bins - 1)
    alpha = pos - idx.float()
    pdf_in = pdf.gather(-1, idx[..., None])[..., 0]
    y = cdf.gather(-1, idx[..., None])[..., 0] + alpha * pdf_in
    y = torch.clamp(y, 0.0, 1.0)
    return y * 2.0 - 1.0, torch.log(pdf_in) - math.log(1.0 / bins)


def spline_inverse(y, logits):
    """One inverse layer (VAE.py:1732-1753): y [..., L] -> (x, log |det|
    of the inverse)."""
    bins = logits.shape[-1]
    v = (_inside(y) + 1.0) / 2.0
    _, cdf = _cdf(logits)
    idx = torch.searchsorted(cdf[..., :-1].contiguous(), v[..., None],
                             right=True)[..., 0] - 1
    idx = torch.clamp(idx, 0, bins - 1)
    edges = torch.linspace(0.0, 1.0, bins + 1, device=y.device)
    slopes = (cdf[..., 1:] - cdf[..., :-1]) / (edges[1:] - edges[:-1])
    offsets = cdf[..., 1:] - slopes * edges[1:]
    slope = slopes.gather(-1, idx[..., None])[..., 0]
    offset = offsets.gather(-1, idx[..., None])[..., 0]
    u = torch.clamp((v - offset) / slope, 0.0, 1.0)
    return u * 2.0 - 1.0, -torch.log(slope)


def _std_normal(z):
    return torch.distributions.Normal(
        torch.zeros_like(z), torch.ones_like(z),
        validate_args=False).log_prob(z)


def flow(eps, logits):
    """(z, log q(z) per latent) of base noise eps [..., L]."""
    z, log_det = eps, torch.zeros_like(eps)
    for _ in range(LAYERS):
        z, ld = spline(z, logits)
        log_det = log_det + ld
    return z, _std_normal(eps) - log_det


def log_prob(z, logits):
    """log q(z) per latent by the inverse pass, in the consistent form."""
    log_det = torch.zeros_like(z)
    for _ in range(LAYERS):
        z, ld = spline_inverse(z, logits)
        log_det = log_det + ld
    return _std_normal(z) + log_det


def _re(x, mean, m):
    """-sum of log N(x * m; mean * m, exp(OBS_LOGVAR * m)) over the cells."""
    scale = torch.exp(0.5 * OBS_LOGVAR * m)
    return -torch.distributions.Normal(mean * m, scale, validate_args=False
                                       ).log_prob(x * m).sum(-1)


@torch.no_grad()
def eval_rows(p, x, mask, eps):
    """One batch's rows: {x_imputed, loss, negl, negl_imp}."""
    _no_tf32()
    z, log_q = flow(eps, context(p, x, mask))
    mean = decode(p, z)
    re = _re(x, mean, mask)
    kl = (log_q - _std_normal(z)).sum(-1)
    return {"x_imputed": mean, "loss": re + kl, "negl": re,
            "negl_imp": _re(x, mean, 1.0 - mask)}


@torch.no_grad()
def evaluate_split(p, cfg, x, mask, perm, eps, batch):
    """One split at one Monte-Carlo rep: (statistics [batches, 4] (rmse,
    loss, negl, negl_imp of each batch), the imputations [batches * batch,
    D]): rows in the order `perm` (wrap-padded to whole batches), batches
    of `batch` rows, eps [batches * batch, L]; a batch's RMSE over the
    missing cells of its real rows, its means over its real rows. The
    split's metrics are the mean over the batches."""
    del cfg
    n = x.shape[0]
    steps = -(-n // batch)
    order = torch.cat([perm, perm[:steps * batch - n]])
    xo, mo = x[order], mask[order]
    rows = [eval_rows(p, xo[s:s + batch], mo[s:s + batch], eps[s:s + batch])
            for s in range(0, steps * batch, batch)]
    r = {k: torch.cat([b[k] for b in rows]) for k in rows[0]}
    w = (torch.arange(steps * batch, device=x.device) < n).float()
    hole = (1.0 - mo) * w[:, None]
    se = torch.square((r["x_imputed"] - xo) * hole).sum(-1)
    per = lambda t: t.reshape(steps, batch).sum(-1)  # noqa: E731
    cnt = per(w)
    rmse = torch.sqrt(per(se) / torch.clamp(per(hole.sum(-1)), min=1.0))
    stats = torch.stack([rmse] + [per(r[k] * w) / cnt for k in
                                  ("loss", "negl", "negl_imp")], dim=1)
    return stats, r["x_imputed"]

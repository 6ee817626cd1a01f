"""Numerical helpers shared by the model families (port of the JAX package's
`ops/math.py`; reference: src/utils/utils.py:18-21, 129-134,
src/models/VAE.py:164-185, 2127-2129, 3073-3076).

Noise is explicit: `reparameterize` takes the standard-normal `eps` or a
`torch.Generator` to draw it from, never a global random state.
"""

from __future__ import annotations

import math

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)

#: the fixed decoder observation log-variance of the plain/EDDI families:
#: log((0.1 * sqrt(2))^2)  (reference: src/models/VAE.py:379 and siblings)
FIXED_X_LOGVAR = math.log((0.1 * math.sqrt(2.0)) ** 2)


def _sum(t, dim):
    return t.sum() if dim is None else t.sum(dim=dim)


def normal_logpdf(x, mean, logvar):
    """Element-wise log N(x; mean, exp(logvar))."""
    return (-0.5 * torch.square(x - mean) * torch.exp(-logvar) - 0.5 * logvar
            - _LOG_SQRT_2PI)


def normal_logpdf_scale(x, mean, scale):
    """Element-wise log N(x; mean, scale^2) parameterized by std."""
    z = (x - mean) / scale
    return -0.5 * torch.square(z) - torch.log(scale) - _LOG_SQRT_2PI


def std_normal_logpdf(z):
    """Element-wise log N(z; 0, I): `normal_logpdf(z, 0, 0)` without the
    zero terms, to the same bits."""
    return -0.5 * torch.square(z) - _LOG_SQRT_2PI


def gaussian_log_likelihood(targets, mean, logvar, dim=None):
    """Sum of element-wise Gaussian log-probs (reference: VAE.py:183-185)."""
    return _sum(normal_logpdf(targets, mean, logvar), dim)


def neg_gaussian_log_likelihood(targets, mean, logvar, dim=None):
    """Negative Gaussian log-likelihood sum (reference: VAE.py:179-181)."""
    return -gaussian_log_likelihood(targets, mean, logvar, dim=dim)


def kl_diag_std(mean, logvar, dim=None):
    """KL( N(mean, exp(logvar)) || N(0, I) ), summed over `dim` (all if None)."""
    kl = 0.5 * (torch.exp(logvar) + torch.square(mean) - 1.0 - logvar)
    return _sum(kl, dim)


def kl_diag_diag(mean1, logvar1, mean2, logvar2, dim=None):
    """KL( N1 || N2 ) for diagonal Gaussians, summed over `dim` (all if
    None) (reference: VAE.py:164-169)."""
    kl = 0.5 * (logvar2 - logvar1
                + (torch.exp(logvar1) + torch.square(mean1 - mean2))
                * torch.exp(-logvar2)
                - 1.0)
    return _sum(kl, dim)


def kl_diag_diag_scale_elems(mean1, scale1, mean2, scale2):
    """Element-wise KL for std-parameterized diagonal Gaussians; the caller
    reduces (the MIWAE regularizer means over all elements, reference:
    VAE.py:3270-3275)."""
    logvar1 = 2.0 * torch.log(scale1)
    logvar2 = 2.0 * torch.log(scale2)
    return 0.5 * (logvar2 - logvar1
                  + (torch.square(scale1) + torch.square(mean1 - mean2))
                  / torch.square(scale2)
                  - 1.0)


def kl_diag_diag_scale(mean1, scale1, mean2, scale2, dim=None):
    """`kl_diag_diag_scale_elems` summed over `dim` (all if None)."""
    return _sum(kl_diag_diag_scale_elems(mean1, scale1, mean2, scale2), dim)


def bernoulli_logits_logpmf(logits, target):
    """Element-wise log Bernoulli(target; sigmoid(logits)), numerically
    stable, as torch.distributions.Bernoulli(logits=...).log_prob
    (reference: VAE.py:2434-2435). At logits == 0 the gradient is the JAX
    package's: jnp.maximum passes half of it and jnp.abs all (its
    derivative at 0 is 1); `maximum` against a 0-d zero and `where(l >= 0,
    l, -l)` do the same (`clamp` would pass all, `abs` none)."""
    zero = torch.zeros((), dtype=logits.dtype)
    abs_logits = torch.where(logits >= 0, logits, -logits)
    return (target * logits - torch.maximum(logits, zero)
            - torch.log1p(torch.exp(-abs_logits)))


def student_t_logpdf(x, loc, scale, df):
    """Element-wise Student-t log-density, the MIWAE decoder likelihood
    (reference: VAE.py:3073-3076)."""
    y = (x - loc) / scale
    return (torch.lgamma(0.5 * (df + 1.0)) - torch.lgamma(0.5 * df)
            - 0.5 * torch.log(df * math.pi) - torch.log(scale)
            - 0.5 * (df + 1.0) * torch.log1p(torch.square(y) / df))


def student_t_head(h):
    """(loc, scale, df) of the Student-t decoder's output h [..., 3D]: a
    sigmoid location, softplus + 0.001 scale and softplus + 3 degrees of
    freedom (reference: VAE.py:3061-3066)."""
    loc, scale, df = h.chunk(3, dim=-1)
    softplus = torch.nn.functional.softplus
    return torch.sigmoid(loc), softplus(scale) + 0.001, softplus(df) + 3.0


def log_mean_exp(x, dim=-1):
    """log(mean(exp(x))) along `dim` (reference: src/utils/utils.py:129-134)."""
    return torch.logsumexp(x, dim=dim) - math.log(x.shape[dim])


def logsumexp(x, dim=0):
    return torch.logsumexp(x, dim=dim)


def softmax_neg(x, dim=1):
    """softmax(-x): self-normalized importance weights from negative
    log-weights (reference: VAE.py:2127-2129, applied to -l_w)."""
    return torch.softmax(-x, dim=dim)


def reparameterize(mean, logvar, *, eps=None, generator=None):
    """z = mean + eps * exp(logvar/2), with `eps` given or drawn from
    `generator` (exactly one of the two)."""
    if (eps is None) == (generator is None):
        raise ValueError("reparameterize: pass exactly one of eps, generator")
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                          dtype=mean.dtype)
    return mean + eps * torch.exp(0.5 * logvar)


# ---------------------------------------------------------------------------
# masked metrics and column transforms
# ---------------------------------------------------------------------------


def masked_rmse(x_hat, x, hole_mask):
    """RMSE over the cells where `hole_mask` is 1 (the reference computes
    it over `~mask`, the missing cells: src/experiment_main/evaluate.py:
    232-234)."""
    se = torch.sum(torch.square(x_hat * hole_mask - x * hole_mask))
    return torch.sqrt(se / torch.clamp(torch.sum(hole_mask), min=1.0))


def check(x, a, b):
    """Whether `x` lies in the closed interval [a, b], elementwise, as a
    bool tensor (reference: src/utils/utils.py:8-15); a scalar gives a 0-d
    tensor."""
    x = torch.as_tensor(x)
    return torch.logical_and(a <= x, x <= b)


def minmax_normalize(data, dim=0):
    """Min-max scale to [0, 1] along `dim` (reference:
    src/utils/loaders.py:327-332)."""
    lo = torch.amin(data, dim=dim, keepdim=True)
    hi = torch.amax(data, dim=dim, keepdim=True)
    return (data - lo) / (hi - lo)


def standardize(data, dim=0):
    """Zero mean and unit variance along `dim`, with Bessel's correction as
    torch's `.std(0)` has it (reference: src/utils/loaders.py:334-336)."""
    mu = torch.mean(data, dim=dim, keepdim=True)
    sd = torch.std(data, dim=dim, keepdim=True, correction=1)
    return (data - mu) / sd

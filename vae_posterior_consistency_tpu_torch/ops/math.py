"""Numerical helpers shared by the model families (port of the JAX package's
`ops/math.py`; reference: src/utils/utils.py:18-21, src/models/VAE.py:164-185).

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


def reparameterize(mean, logvar, *, eps=None, generator=None):
    """z = mean + eps * exp(logvar/2), with `eps` given or drawn from
    `generator` (exactly one of the two)."""
    if (eps is None) == (generator is None):
        raise ValueError("reparameterize: pass exactly one of eps, generator")
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                          dtype=mean.dtype)
    return mean + eps * torch.exp(0.5 * logvar)

"""Tensor and shape helpers of the flow library's vendored support code (port
of the JAX package's `nn/tensor_utils.py`; reference: src/models/VAE.py:
1243-1426, nflows-derived helpers).

All are plain torch functions. Production call site:
`gaussian_kde_log_eval`, the aggregated-posterior density of
`engine/inference.mutual_information_kde`. `searchsorted` is the
reference's spline bin lookup (VAE.py:1392-1394); the port's spline inlines
a clipped variant (`nn/flow.py`). The rest (`tile`, the dim splitters,
`random_orthogonal`, the binary-mask creators, the `is_*` predicates) keep
the names of the vendored block, which the reference's production paths do
not call either. Where the JAX functions take a PRNG key, these take a
`torch.Generator`.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def tile(x, n):
    """Repeat a 1-D tensor n times (reference: VAE.py tile helper)."""
    if n < 1:
        raise ValueError(f"tile: n must be at least 1, got {n}")
    return x.repeat(n)


def sum_except_batch(x, num_batch_dims=1):
    """Sum over all but the leading `num_batch_dims` dims."""
    return x.reshape(*x.shape[:num_batch_dims], -1).sum(dim=-1)


def split_leading_dim(x, shape):
    """Reshape the leading dim into `shape`."""
    return x.reshape(*shape, *x.shape[1:])


def merge_leading_dims(x, num_dims=2):
    """Flatten the first `num_dims` dims into one."""
    return x.reshape(-1, *x.shape[num_dims:])


def repeat_rows(x, num_reps):
    """[B, ...] -> [B*num_reps, ...] with each row repeated contiguously."""
    return torch.repeat_interleave(x, num_reps, dim=0)


def random_orthogonal(generator, size, device="cpu"):
    """A uniformly random orthogonal matrix (QR of a Gaussian drawn from
    `generator`, the signs of R's diagonal moved into Q)."""
    q, r = torch.linalg.qr(torch.randn(size, size, generator=generator,
                                       device=device))
    return q * torch.sign(torch.diagonal(r))[None, :]


def create_alternating_binary_mask(features, even=True):
    """[1,0,1,0,...] (even) or [0,1,0,1,...] coupling mask."""
    mask = torch.arange(features) % 2
    return (1 - mask if even else mask).to(torch.float32)


def create_mid_split_binary_mask(features):
    """First half 1, second half 0."""
    half = (features + 1) // 2
    return (torch.arange(features) < half).to(torch.float32)


def create_random_binary_mask(generator, features):
    """Exactly half (floor) of the positions set to 1, at random."""
    perm = torch.randperm(features, generator=generator)
    mask = torch.zeros(features, dtype=torch.float32)
    mask[perm[:features // 2]] = 1.0
    return mask


def searchsorted(bin_locations, inputs, eps=1e-6):
    """Index i s.t. bin_locations[i] <= v < bin_locations[i+1], along the last
    axis (reference: VAE.py:1392-1394, the spline's bin lookup)."""
    bin_locations = bin_locations.clone()
    bin_locations[..., -1] += eps
    return (inputs[..., None] >= bin_locations).to(torch.int32).sum(
        dim=-1, dtype=torch.int32) - 1


def gaussian_kde_log_eval(samples, query, loo: bool = False):
    """Log of a Gaussian KDE fitted on `samples` [N, D], evaluated at `query`
    [M, D], with Scott's-rule bandwidth per dimension, h_j = sigma_j *
    N^(-1/(D+4)), sigma_j the population std floored at 1e-6.

    `loo=True` leaves the i-th sample's own kernel out when evaluating at
    query row i (query must be the fit samples, row-aligned): the self term
    otherwise inflates the density at its own fit points, which dominates
    at small N."""
    n, d = samples.shape
    sigma = torch.clamp(torch.std(samples, dim=0, correction=0), min=1e-6)
    h = sigma * n ** (-1.0 / (d + 4))  # [d]
    diff = (query[:, None, :] - samples[None, :, :]) / h
    log_kernel = (-0.5 * torch.sum(diff ** 2, dim=-1)
                  - torch.sum(torch.log(h * math.sqrt(2 * math.pi))))
    if not loo:
        return torch.logsumexp(log_kernel, dim=1) - math.log(n)
    if query.shape[0] != n:
        raise ValueError("loo=True needs query == samples (row-aligned)")
    eye = torch.eye(n, dtype=torch.bool, device=samples.device)
    log_kernel = log_kernel.masked_fill(eye, -math.inf)
    return torch.logsumexp(log_kernel, dim=1) - math.log(n - 1)


def is_bool(x):
    return isinstance(x, (bool, np.bool_))


def is_int(x):
    return isinstance(x, (int, np.integer))


def is_positive_int(x):
    return is_int(x) and x > 0


def is_nonnegative_int(x):
    return is_int(x) and x >= 0


def is_power_of_two(n):
    return is_positive_int(n) and (n & (n - 1)) == 0

"""Conditional piecewise-linear spline flow (Mueller et al., Neural Importance
Sampling): the flow posterior of the VAEFlow / REG_VAEFlow families (port of
the JAX package's `nn/flow.py`; reference: src/models/VAE.py:1680-1857).

Structure (reference: src/models/VAE.py:1816-1857 `Flow`): 3 stacked
conditional piecewise-linear CDF transforms on [-1, 1], num_bins =
latent_dim, all fed the same bin logits, the encoder's context reshaped to
(B, dim, num_bins). `flow_forward` pushes base noise through them and
returns (z, log q(z)) element-wise per latent dim; `flow_log_prob` pulls z
back through the inverses. The out-of-interval handling (`tails`) and the
consistent log-det sign of `flow_log_prob` are the JAX package's
(PARITY.md deviation 1).

Where the JAX function takes a PRNG key, `flow_forward` takes the standard
normal base noise `eps` itself. Bins are read with `torch.gather`. The
clips that carry a gradient are `core.hardtanh`, whose gradient at a bound
is 0.5 as `jnp.clip`'s is (`torch.clamp` gives 1).

Without gradients, with float32 products (`ops/fused_iw.fused_eval`, the
rule of the importance-weighted kernels) and without ActNorm,
`flow_forward` normalises the bin logits once and runs the three layers as
one call of F1 (`ops/fused_flow.flow_spline`: the kernel on the card, its
plain version on the CPU), which gives the eager stack's bits; where a
functorch transform wraps its inputs (a vmapped ensemble) it keeps the
eager stack. Training, bf16, ActNorm and `flow_log_prob` run the eager
stack.

Under a torch profiler `flow_forward` and `flow_log_prob` record the span
`flow.spline` around the whole stack and count `flow_rows`, the rows
(leading elements of `eps` or `z`) pushed through it, and `flow_forward`
counts those F1 takes in `flow_fused_rows` (`utils/tracing`).
"""

from __future__ import annotations

import functools
import math

import torch

from vae_posterior_consistency_tpu_torch.nn import core
from vae_posterior_consistency_tpu_torch.ops import fused_flow, fused_iw
from vae_posterior_consistency_tpu_torch.ops.math import std_normal_logpdf
from vae_posterior_consistency_tpu_torch.utils import tracing

NUM_LAYERS = 3
TAIL_BOUND = 1.0


def _normalize_pdf(unnormalized_pdf):
    """softmax over bins -> pdf; cdf with exact 1.0 top and 0.0 left pad
    (reference: src/models/VAE.py:1726-1731). The cumulative sum's last
    entry is replaced, so no gradient flows through it."""
    pdf = torch.softmax(unnormalized_pdf, dim=-1)
    cdf = torch.cumsum(pdf, dim=-1)
    edge = torch.ones_like(cdf[..., :1])
    cdf = torch.cat([torch.zeros_like(edge), cdf[..., :-1], edge], dim=-1)
    return pdf, cdf


def _gather_bins(table, idx):
    """table[..., idx[...]] along the last axis; `idx` has the leading
    shape of `table`."""
    return torch.gather(table, -1, idx.unsqueeze(-1)).squeeze(-1)


def linear_spline_forward(inputs, unnormalized_pdf, left=-1.0, right=1.0,
                          bottom=-1.0, top=1.0):
    """Forward piecewise-linear CDF map on [left,right] -> [bottom,top].

    inputs: (..., D); unnormalized_pdf: (..., D, num_bins).
    Returns (outputs, logabsdet) each (..., D)
    (reference: src/models/VAE.py:1754-1774)."""
    num_bins = unnormalized_pdf.shape[-1]
    pdf, cdf = _normalize_pdf(unnormalized_pdf)

    x = (inputs - left) / (right - left)
    bin_pos = x * num_bins
    bin_idx = torch.clamp(torch.floor(bin_pos).to(torch.int64), 0,
                          num_bins - 1)
    alpha = bin_pos - bin_idx.to(bin_pos.dtype)

    input_pdfs = _gather_bins(pdf, bin_idx)
    cdf_left = _gather_bins(cdf[..., :-1], bin_idx)
    outputs = core.hardtanh(cdf_left + alpha * input_pdfs, 0.0, 1.0)
    logabsdet = torch.log(input_pdfs) - math.log(1.0 / num_bins)
    return outputs * (top - bottom) + bottom, logabsdet


def linear_spline_inverse(inputs, unnormalized_pdf, left=-1.0, right=1.0,
                          bottom=-1.0, top=1.0):
    """Inverse piecewise-linear CDF map
    (reference: src/models/VAE.py:1732-1753)."""
    num_bins = unnormalized_pdf.shape[-1]
    _, cdf = _normalize_pdf(unnormalized_pdf)

    y = (inputs - bottom) / (top - bottom)
    # searchsorted: idx s.t. cdf[idx] <= y < cdf[idx+1]
    # (reference searchsorted: src/models/VAE.py:1392-1394)
    inv_bin_idx = torch.clamp(
        (y[..., None] >= cdf[..., :-1]).sum(dim=-1) - 1, 0, num_bins - 1)
    bin_width = 1.0 / num_bins
    slopes = (cdf[..., 1:] - cdf[..., :-1]) / bin_width
    right_edges = torch.arange(1, num_bins + 1, dtype=inputs.dtype,
                               device=inputs.device) * bin_width
    offsets = cdf[..., 1:] - slopes * right_edges

    input_slopes = _gather_bins(slopes, inv_bin_idx)
    input_offsets = _gather_bins(offsets, inv_bin_idx)
    outputs = core.hardtanh((y - input_offsets) / input_slopes, 0.0, 1.0)
    logabsdet = -torch.log(input_slopes)
    return outputs * (right - left) + left, logabsdet


def unconstrained_linear_spline(inputs, unnormalized_pdf, inverse=False,
                                tail_bound=TAIL_BOUND, tails="clamp"):
    """Spline with out-of-interval handling.

    tails='clamp' (default): inputs outside [-tail_bound, tail_bound] are
    zeroed and spline-mapped like everything else, the reference's effective
    behaviour (VAE.py:1689-1707), which bounds the latent support to the
    spline image.

    tails='linear': identity map and zero logdet outside the interval (a
    true normalizing flow on R^d).
    """
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    safe_inputs = torch.where(inside, inputs, 0.0)
    fn = linear_spline_inverse if inverse else linear_spline_forward
    out_in, logdet_in = fn(safe_inputs, unnormalized_pdf, left=-tail_bound,
                           right=tail_bound, bottom=-tail_bound,
                           top=tail_bound)
    if tails == "clamp":
        return out_in, logdet_in
    outputs = torch.where(inside, out_in, inputs)
    logabsdet = torch.where(inside, logdet_in, 0.0)
    return outputs, logabsdet


# ---------------------------------------------------------------------------
# Conditional flow (3 stacked spline layers fed by one context)
# ---------------------------------------------------------------------------


def context_to_pdf(context, dim, num_bins):
    """Reshape encoder context (..., dim*num_bins) -> bin logits
    (..., dim, num_bins) (reference: src/models/VAE.py:1793)."""
    return context.reshape(*context.shape[:-1], dim, num_bins)


def _spline_stack(pdf_logits, tails, actnorm):
    """The Flow's transform cascade as composite_apply layers: NUM_LAYERS
    conditional splines, interleaved with the ActNorm affines of `actnorm`
    (a list of NUM_LAYERS parameter dicts) when it is given
    (reference: src/models/VAE.py:1627-1657, 1827; RunConfig.flow_actnorm)."""

    def spline(x, context, inverse):
        return unconstrained_linear_spline(x, pdf_logits, inverse=inverse,
                                           tails=tails)

    stack = []
    for i in range(NUM_LAYERS):
        stack.append(spline)
        if actnorm is not None:
            stack.append(
                lambda x, c, inv, p=actnorm[i]: actnorm_apply(p, x, c, inv))
    return stack


def _traced_stack(fn):
    """`fn(x, context, dim, ...)` inside the span `flow.spline`, counting
    the rows of x in `flow_rows`."""

    @functools.wraps(fn)
    def traced(x, context, dim, *args, **kwargs):
        with tracing.span("flow.spline"):
            tracing.count("flow_rows", x.numel() // dim)
            return fn(x, context, dim, *args, **kwargs)

    return traced


def _fused(eps, pdf_logits) -> bool:
    """Whether `flow_forward` (without ActNorm) runs F1: without gradients
    and with float32 products (`fused_iw.fused_eval`), on float32 tensors
    whose cells match (pdf_logits [..., dim, num_bins] over eps [..., dim]),
    which no functorch transform wraps (F1 reads their storage)."""
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    return (fused_iw.fused_eval() and eps.dtype == torch.float32
            and pdf_logits.dtype == torch.float32
            and pdf_logits.shape[:-1] == eps.shape
            and not wrapped(eps) and not wrapped(pdf_logits))


@_traced_stack
def flow_forward(eps, context, dim, num_bins=None, tails="clamp",
                 actnorm=None):
    """Push the base noise `eps` (..., dim) ~ N(0, I) through the 3 spline
    layers (with ActNorm between them when `actnorm` is given).

    Returns (z, log_prob) with log_prob element-wise per latent dim
    (reference: src/models/VAE.py:1829-1841)."""
    num_bins = num_bins or dim
    pdf_logits = context_to_pdf(context, dim, num_bins)
    if actnorm is None and _fused(eps, pdf_logits):
        tracing.count("flow_fused_rows", eps.numel() // dim)
        return fused_flow.flow_spline(eps, *_normalize_pdf(pdf_logits),
                                      tails)
    z = eps
    log_prob = std_normal_logpdf(z)
    if actnorm is not None:
        z, log_det = composite_apply(_spline_stack(pdf_logits, tails, actnorm),
                                     z)
        return z, log_prob - log_det
    log_det = torch.zeros_like(z)
    for _ in range(NUM_LAYERS):
        z, ld = unconstrained_linear_spline(z, pdf_logits, inverse=False,
                                            tails=tails)
        log_det = log_det + ld
    return z, log_prob - log_det


# ---------------------------------------------------------------------------
# General transform combinators (the nflows-style library around the spline
# flow, reference: src/models/VAE.py:1441-1675). A transform is a callable
# fn(x, context, inverse) -> (y, elementwise logabsdet).
# ---------------------------------------------------------------------------


class InverseNotAvailable(Exception):
    """Raised when a transform has no inverse (reference: VAE.py:1429-1432)."""


class InputOutsideDomain(Exception):
    """Raised for out-of-domain spline inputs (reference: VAE.py:1435-1438)."""


def composite_apply(layers, x, context=None, inverse=False):
    """Sequential cascade with logdet accumulation
    (reference: VAE.py:1451-1478). `layers` is a list of callables
    fn(x, context, inverse) -> (y, logabsdet)."""
    log_det = torch.zeros_like(x)
    seq = reversed(layers) if inverse else layers
    for fn in seq:
        x, ld = fn(x, context, inverse)
        log_det = log_det + ld
    return x, log_det


def actnorm_init(dim, device="cuda"):
    """Per-dim affine (log_scale, shift), identity at init
    (reference: VAE.py:1627-1657)."""
    return {"log_scale": torch.zeros(dim, device=device),
            "shift": torch.zeros(dim, device=device)}


def actnorm_apply(params, x, context=None, inverse=False):
    scale = torch.exp(params["log_scale"])
    if inverse:
        y = (x - params["shift"]) / scale
        ld = -params["log_scale"].expand(x.shape)
    else:
        y = x * scale + params["shift"]
        ld = params["log_scale"].expand(x.shape)
    return y, ld


def inverse_transform(fn):
    """Wrap a transform so forward and inverse swap
    (reference: VAE.py:1660-1675)."""

    def wrapped(x, context=None, inverse=False):
        return fn(x, context, not inverse)

    return wrapped


def multiscale_apply(layers, x, context=None):
    """RealNVP-style multiscale cascade: after each transform, split off half
    the dims as latents (reference: VAE.py:1481-1624). Returns
    (concatenated latents, total elementwise logabsdet summed per row)."""
    outputs = []
    log_det = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for i, fn in enumerate(layers):
        x, ld = fn(x, context, False)
        log_det = log_det + ld.sum(dim=-1)
        if i < len(layers) - 1:
            half = x.shape[-1] // 2
            outputs.append(x[..., half:])
            x = x[..., :half]
    outputs.append(x)
    return torch.cat(outputs[::-1], dim=-1), log_det


@_traced_stack
def flow_log_prob(z, context, dim, num_bins=None, tails="clamp",
                  actnorm=None):
    """Element-wise log q(z | context) via the inverse pass
    (reference: src/models/VAE.py:1843-1857), in the consistent form
    log q(y) = log N(f^-1(y)) + sum(inverse logabsdets), which agrees with
    the log-prob `flow_forward` emits (the reference subtracts the inverse
    logdets, VAE.py:1857; PARITY.md deviation 1)."""
    num_bins = num_bins or dim
    pdf_logits = context_to_pdf(context, dim, num_bins)
    if actnorm is not None:
        z, log_det = composite_apply(_spline_stack(pdf_logits, tails, actnorm),
                                     z, inverse=True)
        return std_normal_logpdf(z) + log_det
    log_det = torch.zeros_like(z)
    for _ in range(NUM_LAYERS):
        z, ld = unconstrained_linear_spline(z, pdf_logits, inverse=True,
                                            tails=tails)
        log_det = log_det + ld
    return std_normal_logpdf(z) + log_det

"""F1, the flow posterior's forward spline stack in one call: the CUDA
kernel's wrapper and its plain version.

For the base noise eps [..., L] and the bin tables of each of its cells,
pdf [..., L, nb] and cdf [..., L, nb + 1] (`nn/flow._normalize_pdf` of the
context's bin logits: the softmax, and its cumulative sum with exact 0 and 1
edges), `flow_spline` returns (z, log_prob) [..., L]: eps pushed through the
three conditional linear-spline layers of `nn/flow.flow_forward` without
ActNorm, all three reading the same tables, and log N(eps) minus the three
layers' log-dets. `tails` is `nn/flow`'s: 'clamp' zeroes an input outside
[-1, 1] before its spline, 'linear' also passes it through unchanged with a
log-det of 0.

The kernel, `csrc/flow_spline.cu`, replaces no TPU kernel (the JAX package
computes the flow in plain jnp): one launch, a thread a cell, in place of
the eager stack's three passes of the bin search, the gathers, the clip and
the log-det (about 84 launches). It reproduces the eager composition bit
for bit; its source says how.

`flow_spline` takes the plain version for CPU tensors only: the eager
layers' operations, in their order, on the given tables, which
`nn/flow.flow_forward`'s own eager stack computes to the same bits. For CUDA
tensors it launches the kernel or raises. It has no backward and no
autograd Function: `flow_forward` calls it only without gradients, on
tensors no functorch transform wraps. Calls count in
`ops/_kernel.launches` (`flow_spline`), one device operation each.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vae_posterior_consistency_tpu_torch.nn import core
from vae_posterior_consistency_tpu_torch.ops import _kernel
from vae_posterior_consistency_tpu_torch.ops.math import (
    _LOG_SQRT_2PI,
    std_normal_logpdf,
)

#: the spline layers of the stack (`nn/flow.NUM_LAYERS`) and its interval
#: [-1, 1] (`nn/flow.TAIL_BOUND`), which the kernel fixes (nn/flow imports
#: this module, so they are not read from there)
LAYERS = 3
BOUND = 1.0


def flow_spline_reference(eps, pdf, cdf, tails):
    """The plain version: `nn/flow.unconstrained_linear_spline` and
    `linear_spline_forward` three times on the given tables, the log-dets
    summed from zeros, as `flow_forward` takes them."""
    nb = pdf.shape[-1]
    z = eps
    log_prob = std_normal_logpdf(z)
    log_det = torch.zeros_like(z)
    for _ in range(LAYERS):
        inside = (z >= -BOUND) & (z <= BOUND)
        x = (torch.where(inside, z, 0.0) - (-BOUND)) / (BOUND - (-BOUND))
        bin_pos = x * nb
        bin_idx = torch.clamp(torch.floor(bin_pos).to(torch.int64), 0,
                              nb - 1)
        alpha = bin_pos - bin_idx.to(bin_pos.dtype)
        idx = bin_idx.unsqueeze(-1)
        input_pdfs = torch.gather(pdf, -1, idx).squeeze(-1)
        cdf_left = torch.gather(cdf[..., :-1], -1, idx).squeeze(-1)
        out = core.hardtanh(cdf_left + alpha * input_pdfs, 0.0, 1.0)
        out = out * (BOUND - (-BOUND)) + (-BOUND)
        ld = torch.log(input_pdfs) - math.log(1.0 / nb)
        if tails != "clamp":
            out = torch.where(inside, out, z)
            ld = torch.where(inside, ld, 0.0)
        z = out
        log_det = log_det + ld
    return z, log_prob - log_det


_launch = _kernel.entry(
    "flow_spline", "vpc_flow_spline",
    [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_float, ctypes.c_float],
    "flow_spline", flow_spline_reference)


def _check(eps, pdf, cdf):
    """The kernel's contract; returns nb."""
    _kernel.check_inputs("flow_spline", (eps, pdf, cdf))
    nb = pdf.shape[-1] if pdf.dim() else 0
    if (pdf.shape[:-1] != eps.shape or cdf.shape[:-1] != eps.shape
            or cdf.shape[-1] != nb + 1 or eps.dim() < 1 or nb < 1):
        raise ValueError(f"flow_spline: want eps [..., L], pdf [..., L, nb] "
                         f"and cdf [..., L, nb + 1] with nb >= 1, got "
                         f"{tuple(eps.shape)}, {tuple(pdf.shape)}, "
                         f"{tuple(cdf.shape)}")
    return nb


def flow_spline_kernel(eps, pdf, cdf, tails):
    """One launch on the card: (z, log_prob), each shaped as eps."""
    nb = _check(eps, pdf, cdf)
    eps, pdf, cdf = (t.contiguous() for t in (eps, pdf, cdf))
    z = torch.empty_like(eps)
    log_prob = torch.empty_like(eps)
    _launch(eps.device, eps.data_ptr(), pdf.data_ptr(), cdf.data_ptr(),
            z.data_ptr(), log_prob.data_ptr(), eps.numel(), nb,
            int(tails != "clamp"), _LOG_SQRT_2PI, math.log(1.0 / nb))
    return z, log_prob


def flow_spline(eps, pdf, cdf, tails):
    """(z, log_prob) of the three spline layers, as the module says. CPU
    tensors: the plain version. CUDA tensors: the kernel, each call counted
    (`ops/_kernel.launches`)."""
    if _kernel.on_cpu(eps, pdf, cdf):
        return flow_spline_reference(eps, pdf, cdf, tails)
    return flow_spline_kernel(eps, pdf, cdf, tails)

"""Fused posterior tail: the CUDA kernel's wrapper, its plain version and the
closed-form backward.

    z_b    = mean_b + eps_b * exp(logvar_b / 2)            (b = q, p)
    KL_b   = sum KL(N(mean_b, e^logvar_b) || N(0, I))
    KL_reg = sum KL(q || p)    (reference: src/models/VAE.py:441-442, 469-486)

All six inputs are [B, L] float32; the outputs are z_q, z_p [B, L] and three
0-d tensors.

The forward kernel, `csrc/fused_posterior.cu`, replaces the Pallas kernel of
the JAX package (`ops/fused_posterior.py`, `_fused_forward_impl`); its header
says what bounds it and how it is laid out. The backward is the JAX
package's closed form (`_bwd`), which the JAX package computes in jnp
outside any Pallas call; here it is plain PyTorch in the autograd Function's
backward, on whatever device the inputs lie.

`fused_posterior` takes the plain version, `fused_posterior_reference`, for
CPU tensors only. For CUDA tensors it launches the kernel or raises; there is
no switch back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vae_posterior_consistency_tpu_torch.ops import _build


def fused_posterior_reference(mean_q, logvar_q, mean_p, logvar_p, eps_q,
                              eps_p):
    """The plain formulation (the JAX package's
    `fused_posterior_reference`)."""
    z_q = mean_q + eps_q * torch.exp(0.5 * logvar_q)
    z_p = mean_p + eps_p * torch.exp(0.5 * logvar_p)
    kl_q = 0.5 * torch.sum(torch.exp(logvar_q) + mean_q ** 2 - 1.0 - logvar_q)
    kl_p = 0.5 * torch.sum(torch.exp(logvar_p) + mean_p ** 2 - 1.0 - logvar_p)
    kl_reg = 0.5 * torch.sum(
        logvar_p - logvar_q
        + (torch.exp(logvar_q) + (mean_q - mean_p) ** 2) * torch.exp(-logvar_p)
        - 1.0)
    return z_q, z_p, kl_q, kl_p, kl_reg


def fused_posterior_backward(inputs, dz_q, dz_p, dkl):
    """Closed-form gradients of (z_q, z_p, KL_q, KL_p, KL_reg) with respect to
    the six inputs (the JAX package's `_bwd`), `dkl` = the three scalar
    cotangents as a [3] tensor. eps enters only through z = mean + eps*std,
    so its cotangent is dz*std."""
    mean_q, logvar_q, mean_p, logvar_p, eps_q, eps_p = inputs
    dklq, dklp, dklreg = dkl[0], dkl[1], dkl[2]
    std_q = torch.exp(0.5 * logvar_q)
    std_p = torch.exp(0.5 * logvar_p)
    e_lq, e_lp = torch.exp(logvar_q), torch.exp(logvar_p)
    inv_e_lp = torch.exp(-logvar_p)
    dm = mean_q - mean_p
    g_mq = dz_q + dklq * mean_q + dklreg * dm * inv_e_lp
    g_lq = (dz_q * 0.5 * eps_q * std_q + dklq * 0.5 * (e_lq - 1.0)
            + dklreg * 0.5 * (e_lq * inv_e_lp - 1.0))
    g_mp = dz_p + dklp * mean_p - dklreg * dm * inv_e_lp
    g_lp = (dz_p * 0.5 * eps_p * std_p + dklp * 0.5 * (e_lp - 1.0)
            + dklreg * 0.5 * (1.0 - (e_lq + dm * dm) * inv_e_lp))
    return g_mq, g_lq, g_mp, g_lp, dz_q * std_q, dz_p * std_p


@functools.cache
def _fwd():
    lib = _build.library("fused_posterior")
    blocks = lib.vpc_fused_posterior_blocks
    blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    blocks.restype = ctypes.c_int
    fn = lib.vpc_fused_posterior_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, blocks, fn


def _row_major(t):
    """The kernel takes any row stride but contiguous columns."""
    return t if t.stride(1) == 1 and t.stride(0) >= t.shape[1] else (
        t.contiguous())


def fused_posterior_kernel(mean_q, logvar_q, mean_p, logvar_p, eps_q, eps_p):
    """The forward on the card: (z_q, z_p, kl [3]). Counts each launch in
    `fused_posterior.launches`."""
    tensors = (mean_q, logvar_q, mean_p, logvar_p, eps_q, eps_p)
    devices = {t.device for t in tensors}
    if len(devices) != 1 or mean_q.device.type != "cuda":
        raise ValueError(f"fused_posterior: the six inputs must lie on one "
                         f"CUDA device (or all on the CPU), got "
                         f"{sorted(map(str, devices))}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"fused_posterior: the kernel takes float32 only, got "
                        f"{[str(t.dtype) for t in tensors]}")
    shape = tuple(mean_q.shape)
    if len(shape) != 2 or any(tuple(t.shape) != shape for t in tensors) or (
            min(shape) < 1):
        raise ValueError(f"fused_posterior: want six [B, L] inputs, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    B, L = shape
    tensors = [_row_major(t) for t in tensors]
    lib, blocks, fn = _fwd()
    dev = mean_q.device
    z_q = torch.empty((B, L), device=dev, dtype=torch.float32)
    z_p = torch.empty((B, L), device=dev, dtype=torch.float32)
    partials = torch.empty((blocks(B, L), 3), device=dev, dtype=torch.float32)
    kl = torch.empty((3,), device=dev, dtype=torch.float32)
    code = fn(*(t.data_ptr() for t in tensors),
              *(t.stride(0) for t in tensors),
              z_q.data_ptr(), z_p.data_ptr(), partials.data_ptr(),
              kl.data_ptr(), B, L, dev.index,
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "fused_posterior kernel launch")
    fused_posterior.launches += 1
    return z_q, z_p, kl


class FusedPosterior(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, the plain version on CPU
    tensors. Backward: the closed form, in plain PyTorch on either."""

    @staticmethod
    def forward(ctx, mean_q, logvar_q, mean_p, logvar_p, eps_q, eps_p):
        inputs = (mean_q, logvar_q, mean_p, logvar_p, eps_q, eps_p)
        ctx.save_for_backward(*inputs)
        if all(t.device.type == "cpu" for t in inputs):
            z_q, z_p, kl_q, kl_p, kl_reg = fused_posterior_reference(*inputs)
            return z_q, z_p, torch.stack([kl_q, kl_p, kl_reg])
        return fused_posterior_kernel(*inputs)

    @staticmethod
    def backward(ctx, dz_q, dz_p, dkl):
        grads = fused_posterior_backward(ctx.saved_tensors, dz_q, dz_p, dkl)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def fused_posterior(mean_q, logvar_q, mean_p, logvar_p, eps_q, eps_p):
    """(z_q, z_p, KL_q, KL_p, KL_reg) in one fused pass, differentiable.

    CPU tensors: the plain version. CUDA tensors: the kernel, counted in
    `fused_posterior.launches`."""
    z_q, z_p, kl = FusedPosterior.apply(mean_q, logvar_q, mean_p, logvar_p,
                                        eps_q, eps_p)
    kl_q, kl_p, kl_reg = kl.unbind(0)
    return z_q, z_p, kl_q, kl_p, kl_reg


fused_posterior.launches = 0

"""Fused posterior tail: the CUDA kernels' wrappers, their plain versions and
the autograd Function that ties them together.

    z_b    = mean_b + eps_b * exp(logvar_b / 2)            (b = q, p)
    KL_b   = sum KL(N(mean_b, e^logvar_b) || N(0, I))
    KL_reg = sum KL(q || p)    (reference: src/models/VAE.py:441-442, 469-486)

All six inputs are [B, L] float32; the outputs are z_q, z_p [B, L] and three
0-d tensors.

Both kernels are in `csrc/fused_posterior.cu`, one launch a call each. The
forward replaces the Pallas kernel of the JAX package
(`ops/fused_posterior.py`, `_fused_forward_impl`). The backward is the JAX
package's closed form (`_bwd`), which the JAX package computes in jnp outside
any Pallas call and XLA fuses into one pass; here it is a kernel of its own,
`fused_posterior_backward` its plain version. The source's header says what
bounds them and how they are laid out.

`fused_posterior` (differentiable, through `FusedPosterior`) takes the plain
versions for CPU tensors only. For CUDA tensors it launches the kernels or
raises; there is no switch back to the plain versions. Forward launches
count in `fused_posterior.launches`, backward launches in
`fused_posterior.bwd_launches`.
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
def _lib():
    lib = _build.library("fused_posterior")
    fwd = lib.vpc_fused_posterior_fwd
    fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    bwd = lib.vpc_fused_posterior_bwd
    bwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p, ctypes.c_int]
                    + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    return lib, fwd, bwd


def _row_major(t):
    """The kernels take any row stride but contiguous columns."""
    return t if t.stride(1) == 1 and t.stride(0) >= t.shape[1] else (
        t.contiguous())


def _check(tensors, what):
    """The kernels' contract on the six statistics; returns (B, L)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1 or tensors[0].device.type != "cuda":
        raise ValueError(f"{what}: the six inputs must lie on one CUDA device "
                         f"(or all on the CPU), got "
                         f"{sorted(map(str, devices))}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what}: the kernel takes float32 only, got "
                        f"{[str(t.dtype) for t in tensors]}")
    shape = tuple(tensors[0].shape)
    if len(shape) != 2 or any(tuple(t.shape) != shape for t in tensors) or (
            min(shape) < 1):
        raise ValueError(f"{what}: want six [B, L] inputs, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    return shape


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def fused_posterior_kernel(mean_q, logvar_q, mean_p, logvar_p, eps_q, eps_p):
    """The forward on the card, one launch: (z_q, z_p, kl [3]). Counts each
    launch in `fused_posterior.launches`."""
    tensors = (mean_q, logvar_q, mean_p, logvar_p, eps_q, eps_p)
    B, L = _check(tensors, "fused_posterior")
    tensors = [_row_major(t) for t in tensors]
    lib, fwd, _ = _lib()
    dev = mean_q.device
    z_q = torch.empty((B, L), device=dev, dtype=torch.float32)
    z_p = torch.empty((B, L), device=dev, dtype=torch.float32)
    kl = torch.empty((3,), device=dev, dtype=torch.float32)
    code = fwd(*(t.data_ptr() for t in tensors),
               *(t.stride(0) for t in tensors),
               z_q.data_ptr(), z_p.data_ptr(), kl.data_ptr(), B, L,
               dev.index, _stream(dev))
    _build.check(lib, code, "fused_posterior kernel launch")
    fused_posterior.launches += 1
    return z_q, z_p, kl


def fused_posterior_backward_kernel(inputs, dz_q, dz_p, dkl,
                                    needs=(True,) * 6):
    """The backward on the card, one launch: the gradients of the six inputs
    (None where `needs` says no; the kernel skips those writes). dz_q and
    dz_p may have any strides, dkl [3] any stride; nothing is copied and
    nothing waits on the host. Counts each launch in
    `fused_posterior.bwd_launches`."""
    B, L = _check(inputs, "fused_posterior backward")
    dev = inputs[0].device
    for name, t, shape in (("dz_q", dz_q, (B, L)), ("dz_p", dz_p, (B, L)),
                           ("dkl", dkl, (3,))):
        if t.device != dev or t.dtype != torch.float32 or (
                tuple(t.shape) != shape):
            raise ValueError(f"fused_posterior backward: want {name} "
                             f"float32 {list(shape)} on {dev}, got "
                             f"{t.dtype} {list(t.shape)} on {t.device}")
    inputs = [_row_major(t) for t in inputs]
    lib, _, bwd = _lib()
    grads = [torch.empty((B, L), device=dev, dtype=torch.float32)
             if need else None for need in needs]
    code = bwd(*(t.data_ptr() for t in inputs),
               *(t.stride(0) for t in inputs),
               dz_q.data_ptr(), dz_p.data_ptr(), *dz_q.stride(),
               *dz_p.stride(), dkl.data_ptr(), dkl.stride(0),
               *(g.data_ptr() if g is not None else None for g in grads),
               B, L, dev.index, _stream(dev))
    _build.check(lib, code, "fused_posterior backward kernel launch")
    fused_posterior.bwd_launches += 1
    return tuple(grads)


class FusedPosterior(torch.autograd.Function):
    """Forward and backward: the kernels on CUDA tensors, the plain versions
    on CPU tensors. The backward writes only the gradients autograd asks for
    (training asks for the four statistics, not eps)."""

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
        inputs, need = ctx.saved_tensors, ctx.needs_input_grad
        if all(t.device.type == "cpu" for t in (*inputs, dz_q, dz_p, dkl)):
            grads = fused_posterior_backward(inputs, dz_q, dz_p, dkl)
            return tuple(g if n else None for g, n in zip(grads, need))
        return fused_posterior_backward_kernel(inputs, dz_q, dz_p, dkl,
                                               needs=need)


def fused_posterior(mean_q, logvar_q, mean_p, logvar_p, eps_q, eps_p):
    """(z_q, z_p, KL_q, KL_p, KL_reg) in one fused pass, differentiable.

    CPU tensors: the plain versions. CUDA tensors: the kernels, counted in
    `fused_posterior.launches` (forward) and `fused_posterior.bwd_launches`
    (backward)."""
    z_q, z_p, kl = FusedPosterior.apply(mean_q, logvar_q, mean_p, logvar_p,
                                        eps_q, eps_p)
    kl_q, kl_p, kl_reg = kl.unbind(0)
    return z_q, z_p, kl_q, kl_p, kl_reg


fused_posterior.launches = 0
fused_posterior.bwd_launches = 0

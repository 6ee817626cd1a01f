"""Fused posterior tail: the CUDA kernels' wrappers, their plain versions and
the autograd Function that ties them together.

    z_b    = mean_b + eps_b * exp(logvar_b / 2)            (b = q, p)
    KL_b   = sum KL(N(mean_b, e^logvar_b) || N(0, I))
    KL_reg = sum KL(q || p)    (reference: src/models/VAE.py:441-442, 469-486)

The six inputs are float32, all [B, L] (one run) or all [R, B, L] (R
replicas of an ensemble, each its own posterior); the outputs are z_q, z_p
of the same shape and the three sums of each replica: a [3] tensor for one
run, [R, 3] for R replicas.

Both kernels are in `csrc/fused_posterior.cu`, one launch a call each for
any R (one block a replica in the forward). The forward replaces the Pallas
kernel of the JAX package (`ops/fused_posterior.py`, `_fused_forward_impl`).
The backward is the JAX package's closed form (`_bwd`), which the JAX package
computes in jnp outside any Pallas call and XLA fuses into one pass; here it
is a kernel of its own, `fused_posterior_backward` its plain version. The
source's header says what bounds them and how they are laid out.

`fused_posterior` (differentiable, through `FusedPosterior`) takes the plain
versions for CPU tensors only. For CUDA tensors it launches the kernels or
raises; there is no switch back to the plain versions and no loop over
replicas. Under `torch.func.vmap` (the ensemble trainers vmap a model's loss
over its replicas) `FusedPosterior.vmap` folds the vmapped axis into the
replica axis R, so a vmapped step is one launch of each kernel whatever the
number of replicas, and its `backward` gets each replica's own KL
cotangents. Launches count in `ops/_kernel.launches` (`fused_posterior_fwd`,
`fused_posterior_bwd`).
"""

from __future__ import annotations

import ctypes

import torch

from vae_posterior_consistency_tpu_torch.ops import _kernel
from vae_posterior_consistency_tpu_torch.utils import tracing


def fused_posterior_reference(mean_q, logvar_q, mean_p, logvar_p, eps_q,
                              eps_p):
    """The plain formulation (the JAX package's
    `fused_posterior_reference`), over the last two axes: inputs [..., B, L]
    give sums shaped like the leading axes (0-d for one run)."""
    cells = (-2, -1)
    z_q = mean_q + eps_q * torch.exp(0.5 * logvar_q)
    z_p = mean_p + eps_p * torch.exp(0.5 * logvar_p)
    kl_q = 0.5 * torch.sum(torch.exp(logvar_q) + mean_q ** 2 - 1.0 - logvar_q,
                           dim=cells)
    kl_p = 0.5 * torch.sum(torch.exp(logvar_p) + mean_p ** 2 - 1.0 - logvar_p,
                           dim=cells)
    kl_reg = 0.5 * torch.sum(
        logvar_p - logvar_q
        + (torch.exp(logvar_q) + (mean_q - mean_p) ** 2) * torch.exp(-logvar_p)
        - 1.0, dim=cells)
    return z_q, z_p, kl_q, kl_p, kl_reg


def fused_posterior_backward(inputs, dz_q, dz_p, dkl):
    """Closed-form gradients of (z_q, z_p, KL_q, KL_p, KL_reg) with respect to
    the six inputs (the JAX package's `_bwd`), `dkl` = the three sums'
    cotangents, [3] (or [R, 3] for inputs [R, B, L]). eps enters only
    through z = mean + eps*std, so its cotangent is dz*std."""
    mean_q, logvar_q, mean_p, logvar_p, eps_q, eps_p = inputs
    dklq, dklp, dklreg = (dkl[..., j, None, None] for j in range(3))
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


_fwd = _kernel.entry(
    "fused_posterior", "vpc_fused_posterior_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 6
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3,
    "fused_posterior_fwd", fused_posterior_reference)
_bwd = _kernel.entry(
    "fused_posterior", "vpc_fused_posterior_bwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 6
    + [ctypes.c_void_p] * 2
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int] * 2
    + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3,
    "fused_posterior_bwd", fused_posterior_backward)


def _check(tensors, what):
    """The kernels' contract on the six statistics (and the cotangents
    after them, whose shapes the backward checks); returns (R, B, L), R
    None for [B, L] inputs (one run)."""
    _kernel.check_inputs(what, tensors)
    shape = tuple(tensors[0].shape)
    if len(shape) not in (2, 3) or any(tuple(t.shape) != shape
                                       for t in tensors[:6]) or min(shape) < 1:
        raise ValueError(f"{what}: want six [B, L] or six [R, B, L] inputs, "
                         f"got {[tuple(t.shape) for t in tensors[:6]]}")
    return (None, *shape) if len(shape) == 2 else shape


def _replicas(t):
    """A [B, L] tensor as the one replica of a [1, B, L] view."""
    return t if t.dim() == 3 else t.unsqueeze(0)


def _rows(t):
    """A statistic as the kernels take it: [R, B, L], contiguous columns."""
    return _kernel.columns(_replicas(t), apart=True)


def fused_posterior_kernel(mean_q, logvar_q, mean_p, logvar_p, eps_q, eps_p):
    """The forward on the card, one launch for any number of replicas:
    (z_q, z_p, kl), kl [3] for [B, L] inputs and [R, 3] for [R, B, L]
    inputs."""
    tensors = (mean_q, logvar_q, mean_p, logvar_p, eps_q, eps_p)
    R, B, L = _check(tensors, "fused_posterior")
    tensors = [_rows(t) for t in tensors]
    dev = mean_q.device
    n = R or 1
    z_q = torch.empty((n, B, L), device=dev, dtype=torch.float32)
    z_p = torch.empty((n, B, L), device=dev, dtype=torch.float32)
    kl = torch.empty((n, 3), device=dev, dtype=torch.float32)
    _fwd(dev, *(t.data_ptr() for t in tensors),
         *(t.stride(1) for t in tensors), *(t.stride(0) for t in tensors),
         z_q.data_ptr(), z_p.data_ptr(), kl.data_ptr(), n, B, L)
    if R is None:
        return z_q.view(B, L), z_p.view(B, L), kl.view(3)
    return z_q, z_p, kl


def fused_posterior_backward_kernel(inputs, dz_q, dz_p, dkl,
                                    needs=(True,) * 6):
    """The backward on the card, one launch for any number of replicas: the
    gradients of the six inputs (None where `needs` says no; the kernel
    skips those writes), shaped like the inputs. dz_q and dz_p may have any
    strides, dkl ([3], or [R, 3] for [R, B, L] inputs) any strides; nothing
    is copied and nothing waits on the host."""
    R, B, L = _check((*inputs, dz_q, dz_p, dkl), "fused_posterior backward")
    dev = inputs[0].device
    lead = () if R is None else (R,)
    for name, t, shape in (("dz_q", dz_q, (*lead, B, L)),
                           ("dz_p", dz_p, (*lead, B, L)),
                           ("dkl", dkl, (*lead, 3))):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_posterior backward: want {name} "
                             f"{list(shape)}, got {list(t.shape)}")
    inputs = [_rows(t) for t in inputs]
    dz_q, dz_p = _replicas(dz_q), _replicas(dz_p)
    dkl = dkl if dkl.dim() == 2 else dkl.unsqueeze(0)
    n = R or 1
    grads = [torch.empty((*lead, B, L), device=dev, dtype=torch.float32)
             if need else None for need in needs]
    _bwd(dev, *(t.data_ptr() for t in inputs),
         *(t.stride(1) for t in inputs), *(t.stride(0) for t in inputs),
         dz_q.data_ptr(), dz_p.data_ptr(), *dz_q.stride(), *dz_p.stride(),
         dkl.data_ptr(), *dkl.stride(),
         *(g.data_ptr() if g is not None else None for g in grads), n, B, L)
    return tuple(grads)


class FusedPosterior(torch.autograd.Function):
    """Forward and backward: the kernels on CUDA tensors, the plain versions
    on CPU tensors, for [B, L] inputs or [R, B, L] replicas. The backward
    writes only the gradients autograd asks for (training asks for the four
    statistics, not eps). The vmap rule makes a vmapped call one call of
    this Function over [V*R, B, L]: inputs that are not vmapped (the noise
    an ensemble shares across replicas) are expanded to V replicas without
    a copy."""

    @staticmethod
    def forward(mean_q, logvar_q, mean_p, logvar_p, eps_q, eps_p):
        inputs = (mean_q, logvar_q, mean_p, logvar_p, eps_q, eps_p)
        if _kernel.on_cpu(*inputs):
            z_q, z_p, kl_q, kl_p, kl_reg = fused_posterior_reference(*inputs)
            return z_q, z_p, torch.stack([kl_q, kl_p, kl_reg], dim=-1)
        return fused_posterior_kernel(*inputs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dz_q, dz_p, dkl):
        inputs, need = ctx.saved_tensors, ctx.needs_input_grad
        if _kernel.on_cpu(*inputs, dz_q, dz_p, dkl):
            grads = fused_posterior_backward(inputs, dz_q, dz_p, dkl)
            return tuple(g if n else None for g, n in zip(grads, need))
        return fused_posterior_backward_kernel(inputs, dz_q, dz_p, dkl,
                                               needs=need)

    @staticmethod
    def vmap(info, in_dims, *inputs):
        V = info.batch_size
        # 0 for [B, L] inputs, 1 for [R, B, L]
        lead = _kernel.logical_dim(inputs[0], in_dims[0]) - 2
        folded = [_kernel.fold_replicas(t, d, V, lead)
                  for t, d in zip(inputs, in_dims)]
        z_q, z_p, kl = FusedPosterior.apply(*folded)
        return tuple(_kernel.unfold_replicas(t, V, lead)
                     for t in (z_q, z_p, kl)), (0, 0, 0)


def fused_posterior(mean_q, logvar_q, mean_p, logvar_p, eps_q, eps_p):
    """(z_q, z_p, KL_q, KL_p, KL_reg) in one fused pass, differentiable.

    CPU tensors: the plain versions. CUDA tensors: the kernels, each launch
    counted (`ops/_kernel.launches`). The host's side of the forward is the
    span `ops.fused_posterior` (`utils/tracing`)."""
    with tracing.span("ops.fused_posterior"):
        z_q, z_p, kl = FusedPosterior.apply(mean_q, logvar_q, mean_p,
                                            logvar_p, eps_q, eps_p)
    kl_q, kl_p, kl_reg = kl.unbind(-1)
    return z_q, z_p, kl_q, kl_p, kl_reg


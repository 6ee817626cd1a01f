"""IW1, the importance-weighted MIWAE terms in one pass: the CUDA kernel's
wrapper, its plain version and the autograd Function that carries its vmap
rule.

For a stream of rows x, mask [B, D], the encoder's mean and scale [B, L],
the noise eps [B, K, L] and the Student-t decoder (`models/layers`, widths
L-128-128-3D), every sample (b, k) gets z = mean_b + scale_b * eps_bk, the
decoder's location, scale and degrees of freedom, and the Student-t
log-density of x_b under them. Returned: x_mean [B, K, D] (the location)
and terms [4, B, K] (logpxobs, logpx_imp: the log-density summed under mask
and under 1 - mask; logpz, logq: log N(z; 0, I) and log N(z; mean, scale)
summed over L), or [5, B, K] where `extra` [B_extra, D] is given: the
log-density summed under `extra` for the first B_extra rows, 0 on the
others. With a leading replica axis R on every input (an ensemble's
replicas, each with its own decoder) the outputs are [R, B, K, D] and
[R, 4 or 5, B, K].

The kernel, `csrc/iw_decode.cu`, replaces no TPU kernel (the JAX package
computes MIWAE in plain jnp): it keeps the decoder's [B*K, 128] activations
and the density's intermediates out of device memory, which the eager
composition wrote and read again a dozen times a batch. Its source says what
bounds it and how it is laid out.

`iw_fused` takes the plain version for CPU tensors only: the eager
composition of `models/miwae.forward` and `_branch_terms`, to the bit. For
CUDA tensors it launches the kernel or raises; there is no switch back to
the plain version. It has no backward: call it without gradients. Under
`torch.func.vmap` `IwFused.vmap` folds the vmapped axis into the replica
axis, so a vmapped call is one launch. Launches count in
`ops/_kernel.launches` (`iw_fused`).
"""

from __future__ import annotations

import ctypes

import torch

from vae_posterior_consistency_tpu_torch.nn import core
from vae_posterior_consistency_tpu_torch.ops import _kernel
from vae_posterior_consistency_tpu_torch.ops.math import (
    normal_logpdf_scale,
    std_normal_logpdf,
    student_t_head,
    student_t_logpdf,
)

#: the decoder's hidden width, which the kernel fixes (csrc/iw_decode.cu `kH`)
HIDDEN = 128
#: the largest latent width the kernel takes (`kMaxL`)
MAX_LATENT = 32
#: samples a tile of the kernel (`kT`), and tile groups a block (`kGroups`)
TILE = 64
GROUPS = 2
#: replicas a launch takes at most (the grid's y axis)
MAX_REPLICAS = 65535

_LEAVES = ("w1", "b1", "w2", "b2", "w3", "b3")


def decoder_leaves(decoder) -> tuple:
    """The Student-t decoder's (w1, b1, w2, b2, w3, b3)."""
    return tuple(decoder[f"layer{i}"][k] for i in range(3) for k in "wb")


def iw_fused_reference(x, mask, extra, mean, scale, eps, w1, b1, w2, b2, w3,
                       b3):
    """The plain version for one run: the eager composition (the decoder
    through `nn/core.mlp_apply`, `ops/math.student_t_logpdf`, the masked
    sums), reduced to IW1's outputs (x_mean, terms)."""
    decoder = {f"layer{i}": {"w": w, "b": b}
               for i, (w, b) in enumerate(((w1, b1), (w2, b2), (w3, b3)))}
    z = mean[:, None, :] + scale[:, None, :] * eps
    x_mean, x_scale, df = student_t_head(
        core.mlp_apply(decoder, z, hidden_act="relu"))
    m = mask[:, None, :]
    log_pxz = student_t_logpdf(x[:, None, :], x_mean, x_scale, df)
    terms = [torch.sum(log_pxz * m, dim=-1),
             torch.sum(log_pxz * (1.0 - m), dim=-1),
             torch.sum(std_normal_logpdf(z), dim=-1),
             torch.sum(normal_logpdf_scale(z, mean[:, None, :],
                                           scale[:, None, :]), dim=-1)]
    if extra is not None:
        n = extra.shape[0]
        terms.append(torch.cat([
            torch.sum(log_pxz[:n] * extra[:, None, :], dim=-1),
            log_pxz.new_zeros((x.shape[0] - n, eps.shape[1]))]))
    return x_mean, torch.stack(terms)


class _Pointers(ctypes.Structure):
    """`IwPointers` of csrc/iw_decode.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x", "mask", "extra", "mean", "scale", "eps", *_LEAVES, "x_mean",
        "terms")]


class _Strides(ctypes.Structure):
    """`IwStrides`: row strides (ld_), then replica strides (rs_)."""
    _fields_ = [(n, ctypes.c_longlong) for n in (
        "ld_x", "ld_mask", "ld_extra", "ld_mean", "ld_scale", "rs_x",
        "rs_mask", "rs_extra", "rs_mean", "rs_scale", "rs_eps",
        *(f"rs_{n}" for n in _LEAVES))]


class _Dims(ctypes.Structure):
    """`IwDims`."""
    _fields_ = [(n, ctypes.c_int) for n in ("R", "B", "K", "D", "L",
                                             "B_extra", "blocks")]


_launch = _kernel.entry(
    "iw_decode", "vpc_iw_decode",
    [ctypes.POINTER(_Pointers), ctypes.POINTER(_Strides),
     ctypes.POINTER(_Dims)], "iw_fused", iw_fused_reference)


def _shapes(x, mask, extra, mean, scale, eps, leaves):
    """The kernel's contract; returns (lead, B, K, D, L, B_extra), lead 1
    for inputs with a replica axis."""
    _kernel.check_inputs("iw_fused", (x, mask, extra, mean, scale, eps,
                                      *leaves))
    lead = x.dim() - 2
    R = tuple(x.shape[:lead])
    B, D = x.shape[lead:] if lead in (0, 1) else (0, 0)
    K, L = eps.shape[-2:]
    Be = B if extra is None else extra.shape[-2]
    H = HIDDEN
    want = {"x": (B, D), "mask": (B, D), "extra": (Be, D), "mean": (B, L),
            "scale": (B, L), "eps": (B, K, L), "w1": (L, H), "b1": (H,),
            "w2": (H, H), "b2": (H,), "w3": (H, 3 * D), "b3": (3 * D,)}
    got = {k: None if t is None else tuple(t.shape) for k, t in zip(
        want, (x, mask, extra, mean, scale, eps, *leaves))}
    bad = {k: shape for k, shape in got.items()
           if shape is not None and shape != (*R, *want[k])}
    if lead not in (0, 1) or bad or min(B, D, K, L, *R) < 1 or Be < 1:
        raise ValueError(f"iw_fused: want {want} (each with one leading "
                         f"replica axis, or none), got {bad or got}")
    if (L > MAX_LATENT or (R and R[0] > MAX_REPLICAS)
            or B * K * max(D, L, 5) >= 2**31):
        raise ValueError(f"iw_fused: the kernel takes a latent width of at "
                         f"most {MAX_LATENT}, at most {MAX_REPLICAS} "
                         f"replicas and B*K*max(D, L, 5) below 2^31 (its "
                         f"indices are ints), got L={L}, R={R}, B={B}, K={K}, "
                         f"D={D}")
    return lead, B, K, D, L, Be


def iw_fused_kernel(x, mask, extra, mean, scale, eps, *leaves):
    """One launch on the card for one run or R replicas: (x_mean, terms),
    shaped as the module says."""
    lead, B, K, D, L, Be = _shapes(x, mask, extra, mean, scale, eps, leaves)
    rows = [None if t is None else _kernel.columns(t)
            for t in (x, mask, extra, mean, scale)]
    rest = [_kernel.replica_slices(t, lead) for t in (eps, *leaves)]
    R = x.shape[:lead]
    n = R[0] if lead else 1
    dev = x.device
    x_mean = torch.empty((*R, B, K, D), device=dev, dtype=torch.float32)
    terms = torch.empty((*R, 4 if extra is None else 5, B, K), device=dev,
                        dtype=torch.float32)
    tiles = -(-B * K // TILE)
    blocks = min(-(-tiles // GROUPS), max(1, _kernel.sm_count(dev.index) // n))

    def replicas(t):  # the replica stride, 0 for one run
        return t.stride(0) if lead and t is not None else 0

    ptrs = _Pointers(*(None if t is None else t.data_ptr() for t in rows),
                     *(t.data_ptr() for t in rest), x_mean.data_ptr(),
                     terms.data_ptr())
    strides = _Strides(*(0 if t is None else t.stride(-2) for t in rows),
                       *map(replicas, rows), *map(replicas, rest))
    dims = _Dims(n, B, K, D, L, 0 if extra is None else Be, blocks)
    _launch(dev, ctypes.byref(ptrs), ctypes.byref(strides),
            ctypes.byref(dims))
    return x_mean, terms


class IwFused(torch.autograd.Function):
    """IW1 on CUDA tensors, the plain version on CPU tensors (one replica
    at a time where there is a replica axis); its outputs take no gradient
    and it has no backward. The vmap rule makes a vmapped call one call of
    this Function with the vmapped axis folded into the replica axis:
    inputs that are not vmapped (the noise an ensemble's replicas share,
    their rows) are expanded without a copy."""

    @staticmethod
    def forward(x, mask, extra, mean, scale, eps, *leaves):
        inputs = (x, mask, extra, mean, scale, eps, *leaves)
        if not _kernel.on_cpu(*inputs):
            return iw_fused_kernel(*inputs)
        if x.dim() == 2:
            return iw_fused_reference(*inputs)
        outs = [iw_fused_reference(*(None if t is None else t[r]
                                     for t in inputs))
                for r in range(x.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*output)

    @staticmethod
    def vmap(info, in_dims, *inputs):
        V = info.batch_size
        lead = _kernel.logical_dim(inputs[0], in_dims[0]) - 2  # x [B, D]: 0
        folded = [None if t is None else _kernel.fold_replicas(t, d, V, lead)
                  for t, d in zip(inputs, in_dims)]
        x_mean, terms = IwFused.apply(*folded)
        return (_kernel.unfold_replicas(x_mean, V, lead),
                _kernel.unfold_replicas(terms, V, lead)), (0, 0)


def iw_fused(x, mask, extra, mean, scale, eps, decoder):
    """(x_mean [B, K, D], terms [4 or 5, B, K]) in one pass, as the module
    says; `decoder` the Student-t decoder's parameters ({"layer0": {"w",
    "b"}, ...}), `extra` [B_extra, D] or None. Not differentiable: raises
    where gradients are enabled and an input requires one.

    CPU tensors: the plain version. CUDA tensors: the kernel, each launch
    counted (`ops/_kernel.launches`)."""
    inputs = (x, mask, extra, mean, scale, eps, *decoder_leaves(decoder))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        raise RuntimeError("iw_fused has no backward: call it under "
                           "torch.no_grad()")
    return IwFused.apply(*inputs)

"""IW1, MIWAE's importance-weighted evaluation step in one call: the CUDA
kernel's wrapper, its plain version and the autograd Function that carries
its vmap rule.

For a stream of rows x, mask [B, D], the noise eps [B, K, L], the encoder
(`models/layers.miwae_encoder_apply`, widths D-128-128-2L) and the
Student-t decoder (widths L-128-128-3D), the encoder gives every row its
mean and scale [B, L]; every sample (b, k) gets z = mean_b + scale_b *
eps_bk, the decoder's location, scale and degrees of freedom, and the
Student-t log-density of x_b under them, summed under mask (logpxobs),
under 1 - mask (logpx_imp) and, where `extra` [B_extra, D] is given, under
`extra` for the first B_extra rows; log_w = logpxobs + log p(z) - log q.
Then each row is reduced over its K samples (`reduce_over_k`). Returned:

- x_imputed [B, D]: sum_k softmax_k(log_w) loc_k;
- per_row [3, B]: -logsumexp_k log_w; sum_k logpx_imp / `divisor`; the
  mean over k of the sum under `extra` (0 on rows from B_extra on, and
  everywhere without `extra`);
- mean, scale [B, L]: the encoder's.

With a leading replica axis R on every input (an ensemble's replicas, each
with its own encoder and decoder) the outputs are [R, B, D], [R, 3, B],
and [R, B, L] for mean and scale.

The kernel, `csrc/iw_decode.cu`, replaces no TPU kernel (the JAX package
computes MIWAE in plain jnp): one call launches the encoder and then the
body, which keeps the decoder's [B*K, 128] activations, the density and the
[B, K] terms out of device memory and reduces over K in its epilogue. Its
source says what bounds it and how it is laid out.

IW2 (`ops/fused_iw_mnar`, notMIWAE's step) shares the source: one skeleton,
instantiated for each model by a policy. This module's `grid` and
`slot_scratch_floats` size both launches, and `fused_eval` is the rule by
which either model's `eval_step` takes its kernel.

`iw_fused` takes the plain version for CPU tensors only: the eager
composition of `models/miwae.forward`, `_branch_terms` and `reduce_over_k`,
to the bit. For CUDA tensors it launches the kernel or raises; there is no
switch back to the plain version. It has no backward: call it without
gradients. Under `torch.func.vmap` `IwFused.vmap` folds the vmapped axis
into the replica axis, so a vmapped call is one call. Calls count in
`ops/_kernel.launches` (`iw_fused`), one a call: its two device operations
are the encoder's and the body's.
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

#: the networks' hidden width, which the kernel fixes (csrc/iw_decode.cu
#: `kH`)
HIDDEN = 128
#: the largest latent width the kernel takes (`kMaxL`)
MAX_LATENT = 32
#: samples a tile of the kernel (`kT`), tile groups a block (`kGroups`) and
#: features a chunk of its head (`kChunkF`)
TILE = 64
GROUPS = 2
CHUNK = 16
#: replicas a launch takes at most (the grid's y axis)
MAX_REPLICAS = 65535

_LEAVES = ("w1", "b1", "w2", "b2", "w3", "b3")


def mlp_leaves(mlp) -> tuple:
    """A three-layer network's (w1, b1, w2, b2, w3, b3): the encoder's or
    the Student-t decoder's."""
    return tuple(mlp[f"layer{i}"][k] for i in range(3) for k in "wb")


def _mlp(leaves):
    return {f"layer{i}": {"w": leaves[2 * i], "b": leaves[2 * i + 1]}
            for i in range(3)}


def sample_terms(x, mask, extra, mean, scale, eps, decoder):
    """The per-sample terms, as `models/miwae.forward` and `_branch_terms`
    compute them: (x_mean [B, K, D], terms [4 or 5, B, K]): logpxobs,
    logpx_imp, log p(z), log q and, with `extra`, the sum under it on the
    first B_extra rows (0 on the others)."""
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


def reduce_over_k(log_w, x_mean, logpx_imp, extra_sum, divisor):
    """Each row's reductions over its K samples, as the eager
    `models/miwae.eval_step` takes them: (x_imputed [B, D], per_row [3, B]),
    shaped as the module says; `extra_sum` [B_extra, K] or None."""
    B = log_w.shape[0]
    x_imputed = torch.einsum("bk,bkd->bd", torch.softmax(log_w, dim=1),
                             x_mean)
    extra = log_w.new_zeros(B)
    if extra_sum is not None:
        extra = torch.cat([torch.mean(extra_sum, dim=1),
                           extra[extra_sum.shape[0]:]])
    return x_imputed, torch.stack([-torch.logsumexp(log_w, dim=1),
                                   torch.sum(logpx_imp, dim=1) / divisor,
                                   extra])


def iw_fused_reference(x, mask, extra, eps, divisor, *leaves):
    """The plain version for one run: the eager composition (the encoder
    and the decoder through `nn/core.mlp_apply`, `ops/math`'s densities,
    the masked sums, `reduce_over_k`), reduced to IW1's outputs; `leaves`
    the encoder's six, then the decoder's."""
    h = core.mlp_apply(_mlp(leaves[:6]), x * mask, hidden_act="relu")
    mean, pre_scale = h.chunk(2, dim=-1)
    scale = torch.nn.functional.softplus(pre_scale)
    x_mean, terms = sample_terms(x, mask, extra, mean, scale, eps,
                                 _mlp(leaves[6:]))
    log_w = terms[0] + terms[2] - terms[3]
    extra_sum = None if extra is None else terms[4, :extra.shape[0]]
    return (*reduce_over_k(log_w, x_mean, terms[1], extra_sum, divisor),
            mean, scale)


class _Pointers(ctypes.Structure):
    """`IwPointers` of csrc/iw_decode.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x", "mask", "extra", "eps", *(f"e{n}" for n in _LEAVES), *_LEAVES,
        "x_imputed", "per_row", "mean", "scale", "work")]


class _Strides(ctypes.Structure):
    """`IwStrides`: row strides (ld_), then replica strides (rs_)."""
    _fields_ = [(n, ctypes.c_longlong) for n in (
        "ld_x", "ld_mask", "ld_extra", "rs_x", "rs_mask", "rs_extra",
        "rs_eps", *(f"rs_e{n}" for n in _LEAVES),
        *(f"rs_{n}" for n in _LEAVES))]


class _Dims(ctypes.Structure):
    """`IwDims`."""
    _fields_ = [*((n, ctypes.c_int) for n in ("R", "B", "K", "D", "L",
                                              "B_extra", "blocks", "parts")),
                ("divisor", ctypes.c_float), ("work_floats", ctypes.c_longlong)]


_launch = _kernel.entry(
    "iw_decode", "vpc_iw_decode",
    [ctypes.POINTER(_Pointers), ctypes.POINTER(_Strides),
     ctypes.POINTER(_Dims)], "iw_fused", iw_fused_reference)


def fused_eval() -> bool:
    """Whether a model's `eval_step` runs its fused kernel (IW1 for MIWAE,
    IW2 for notMIWAE): without gradients (neither has a backward) and with
    float32 products (both compute in float32 only)."""
    return not torch.is_grad_enabled() and core.active_dtype() == "float32"


def slot_scratch_floats(B, D, blocks, parts, head) -> int:
    """A replica's slots and scratch in the kernels' workspace
    (`slot_scratch_floats` of the source): (parts + B) slots of D + `head`
    floats, and for D > CHUNK a [TILE, D] scratch and two running slots a
    tile group."""
    F = D + head
    scratch = blocks * GROUPS * (TILE * D + 2 * F) if D > CHUNK else 0
    return (parts + B) * F + scratch


def grid(B, K, replicas, device) -> tuple:
    """The body's (blocks a replica, ranges of tiles) for B x K samples: a
    block an SM shared by the replicas, a range a tile group on one
    replica, so the ranges (and the sums) depend on the shapes and the
    card alone."""
    tiles = -(-B * K // TILE)
    sms = _kernel.sm_count(device.index)
    blocks = min(-(-tiles // GROUPS), max(1, sms // replicas))
    parts = min(GROUPS * min(-(-tiles // GROUPS), sms), tiles)
    return blocks, parts


def _work_floats(R, B, D, blocks, parts) -> int:
    """IW1's workspace in floats (`work_floats` of the source): a replica's
    slots of D + 4 floats and scratch, then a ticket a replica."""
    return R * slot_scratch_floats(B, D, blocks, parts, 4) + R


def _shapes(x, mask, extra, eps, leaves):
    """The kernel's contract; returns (lead, B, K, D, L, B_extra), lead 1
    for inputs with a replica axis."""
    _kernel.check_inputs("iw_fused", (x, mask, extra, eps, *leaves))
    lead = x.dim() - 2
    R = tuple(x.shape[:lead])
    B, D = x.shape[lead:] if lead in (0, 1) else (0, 0)
    K, L = eps.shape[-2:]
    Be = B if extra is None else extra.shape[-2]
    H = HIDDEN
    want = {"x": (B, D), "mask": (B, D), "extra": (Be, D), "eps": (B, K, L),
            "encoder w1": (D, H), "encoder b1": (H,), "encoder w2": (H, H),
            "encoder b2": (H,), "encoder w3": (H, 2 * L),
            "encoder b3": (2 * L,), "w1": (L, H), "b1": (H,), "w2": (H, H),
            "b2": (H,), "w3": (H, 3 * D), "b3": (3 * D,)}
    got = {k: None if t is None else tuple(t.shape) for k, t in zip(
        want, (x, mask, extra, eps, *leaves))}
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


def iw_fused_kernel(x, mask, extra, eps, divisor, *leaves):
    """One call on the card for one run or R replicas, two device
    operations (the encoder, the body): (x_imputed, per_row, mean, scale),
    shaped as the module says."""
    lead, B, K, D, L, Be = _shapes(x, mask, extra, eps, leaves)
    rows = [None if t is None else _kernel.columns(t)
            for t in (x, mask, extra)]
    rest = [_kernel.replica_slices(t, lead) for t in (eps, *leaves)]
    R = x.shape[:lead]
    n = R[0] if lead else 1
    dev = x.device
    blocks, parts = grid(B, K, n, dev)
    work_floats = _work_floats(n, B, D, blocks, parts)
    outs = [torch.empty(shape, device=dev, dtype=torch.float32)
            for shape in ((*R, B, D), (*R, 3, B), (*R, B, L), (*R, B, L),
                          (work_floats,))]

    def replicas(t):  # the replica stride, 0 for one run
        return t.stride(0) if lead and t is not None else 0

    ptrs = _Pointers(*(None if t is None else t.data_ptr() for t in rows),
                     *(t.data_ptr() for t in rest),
                     *(t.data_ptr() for t in outs))
    strides = _Strides(*(0 if t is None else t.stride(-2) for t in rows),
                       *map(replicas, rows), *map(replicas, rest))
    dims = _Dims(n, B, K, D, L, 0 if extra is None else Be, blocks, parts,
                 divisor, work_floats)
    _launch(dev, ctypes.byref(ptrs), ctypes.byref(strides),
            ctypes.byref(dims))
    return tuple(outs[:4])


class IwFused(torch.autograd.Function):
    """IW1 on CUDA tensors, the plain version on CPU tensors (one replica
    at a time where there is a replica axis); its outputs take no gradient
    and it has no backward. The vmap rule makes a vmapped call one call of
    this Function with the vmapped axis folded into the replica axis:
    inputs that are not vmapped (the noise an ensemble's replicas share,
    their rows) are expanded without a copy."""

    @staticmethod
    def forward(x, mask, extra, eps, divisor, *leaves):
        inputs = (x, mask, extra, eps, *leaves)
        if not _kernel.on_cpu(*inputs):
            return iw_fused_kernel(x, mask, extra, eps, divisor, *leaves)
        if x.dim() == 2:
            return iw_fused_reference(x, mask, extra, eps, divisor, *leaves)
        outs = [iw_fused_reference(
            *(None if t is None else t[r] for t in (x, mask, extra, eps)),
            divisor, *(t[r] for t in leaves)) for r in range(x.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*output)

    @staticmethod
    def vmap(info, in_dims, x, mask, extra, eps, divisor, *leaves):
        V = info.batch_size
        lead = _kernel.logical_dim(x, in_dims[0]) - 2  # x [B, D]: 0
        folded = [None if t is None else _kernel.fold_replicas(t, d, V, lead)
                  for t, d in zip((x, mask, extra, eps, *leaves),
                                  (*in_dims[:4], *in_dims[5:]))]
        outs = IwFused.apply(*folded[:4], divisor, *folded[4:])
        return (tuple(_kernel.unfold_replicas(t, V, lead) for t in outs),
                (0,) * len(outs))


def iw_fused(x, mask, extra, eps, encoder, decoder, divisor):
    """(x_imputed [B, D], per_row [3, B], mean [B, L], scale [B, L]) in one
    call, as the module says; `encoder` and `decoder` the networks' parameters
    ({"layer0": {"w", "b"}, ...}), `extra` [B_extra, D] or None, `divisor`
    a float. Not differentiable: raises where gradients are enabled and an
    input requires one.

    CPU tensors: the plain version. CUDA tensors: the kernel, each call
    counted (`ops/_kernel.launches`)."""
    leaves = (*mlp_leaves(encoder), *mlp_leaves(decoder))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, mask, extra, eps, *leaves)):
        raise RuntimeError("iw_fused has no backward: call it under "
                           "torch.no_grad()")
    return IwFused.apply(x, mask, extra, eps, float(divisor), *leaves)

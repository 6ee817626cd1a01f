"""Fused EDDI embed + masked pool: the CUDA kernels' wrappers, their plain
versions and the autograd Function that ties them together.

    agg[s,b,k] = sum_d masks[s,b,d] * relu(x[b,d] * A[d,k] + C[d,k])

x [B, D], masks [S, B, D], A and C [D, K] (from
`models/layers._pointnet_affine`), all float32 -> agg [S, B, K] float32; or
the same with a leading replica axis R on every tensor (x [R, B, D], masks
[R, S, B, D], A and C [R, D, K] -> agg [R, S, B, K]), R replicas of an
ensemble, each with its own A and C.

The kernels, in `csrc/embed_pool.cu`, replace the forward and backward
Pallas kernels of the JAX package (`ops/fused_embed_pool.py`, `_fwd_call`
and `_bwd_call`); the source's header says what bounds them and how they are
laid out. Each is one launch per call for any R, reads A and C in place in
their [D, K] layout, and takes any S and K, as the JAX kernels do. The
backward recomputes the embed and returns dx, dmasks, dA, dC (dA and dC
[D, K], or [R, D, K] summed over each replica's own rows).

`embed_pool` (differentiable, through `EmbedPool`) takes the plain versions,
`embed_pool_reference` and `embed_pool_bwd_reference`, for CPU tensors only.
For CUDA tensors it launches the kernels or raises; there is no switch back
to the plain versions and no loop over replicas. Under `torch.func.vmap`
`EmbedPool.vmap` folds the vmapped axis into the replica axis, so a vmapped
call is one launch whatever the number of replicas. Launches count in
`ops/_kernel.launches` (`embed_pool_fwd`, `embed_pool_bwd`).
"""

from __future__ import annotations

import ctypes

import torch

from vae_posterior_consistency_tpu_torch.ops import _kernel
from vae_posterior_consistency_tpu_torch.utils import tracing

#: values of k one forward block takes (csrc/embed_pool.cu `kChunkK`)
CHUNK_K = 16
#: warps of a forward block (csrc/embed_pool.cu `kWarps`)
WARPS = 8
#: bytes of A and C a forward block stages in shared memory at most; the H100
#: gives one block up to 227 KB. Beyond it the kernel reads them from global
#: memory.
STAGE_BYTES = 200 * 1024
#: replicas a launch takes at most (the grid's last axis)
MAX_REPLICAS = 65535


def embed_pool_reference(x, masks, A, C):
    """The plain formulation: materialize the [B, D, K] embed, then pool
    (each replica's, for inputs with a replica axis)."""
    emb = torch.relu(x[..., None] * A.unsqueeze(-3) + C.unsqueeze(-3))
    return torch.einsum("...sbd,...bdk->...sbk", masks, emb)


def embed_pool_bwd_reference(x, masks, A, C, g):
    """The plain backward (the JAX package's `_bwd_kernel`): given
    g = d loss / d agg [S,B,K], returns (dx [B,D], dmasks [S,B,D],
    dA [D,K], dC [D,K]) with the embed recomputed; with a replica axis,
    each replica's."""
    pre = x[..., None] * A.unsqueeze(-3) + C.unsqueeze(-3)  # [..., B, D, K]
    act = (pre > 0.0).to(x.dtype)
    emb = torch.relu(pre)
    gsum = torch.einsum("...sbd,...sbk->...bdk", masks, g)
    gact = gsum * act
    dx = torch.einsum("...bdk,...dk->...bd", gact, A)
    dmasks = torch.einsum("...bdk,...sbk->...sbd", emb, g)
    dA = torch.einsum("...bd,...bdk->...dk", x, gact)
    dC = gact.sum(dim=-3)
    return dx, dmasks, dA, dC


def fwd_plan(B, D, K, n_sm):
    """The forward kernel's tiling for x [B,D] and A [D,K] on a card with
    `n_sm` SMs: (k_chunk, segments, rows_per_block, staged).

    K splits into the fewest chunks of at most CHUNK_K values, as even as can
    be (one chunk per block on grid y). Rows split into about one block per
    SM over all chunks, so A and C are staged once per block and the card
    gets one wave; from 16 rows an SM on, two blocks an SM, so that twice
    the warps hide the loads' latency. A block's 8 warps split into row
    slots x `segments` d segments, as many slots as the tile has rows (a
    power of two). A and C are staged in shared memory when a block has
    more than one row to reuse them for and a chunk of them, stored as
    (A, C) pairs with an odd pitch, fits in STAGE_BYTES; a block of one row
    reads each value once, and reads it sooner from global memory."""
    n_kc = -(-K // CHUNK_K)
    k_chunk = -(-K // n_kc)
    waves = 2 if B >= 16 * n_sm else 1
    tiles = min(B, max(1, -(-waves * n_sm // n_kc)))
    rows = -(-B // tiles)
    segments = WARPS // min(WARPS, 1 << (rows.bit_length() - 1))
    staged = rows > 1 and D * (k_chunk | 1) * 8 <= STAGE_BYTES
    return k_chunk, segments, rows, staged


_fwd = _kernel.entry(
    "embed_pool", "vpc_embed_pool_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 2
    + [ctypes.c_int], "embed_pool_fwd", embed_pool_reference)
_bwd = _kernel.entry(
    "embed_pool", "vpc_embed_pool_bwd",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
    + [ctypes.c_int], "embed_pool_bwd", embed_pool_bwd_reference)


def _check(x, masks, A, C, what):
    """The kernels' contract on CUDA tensors; returns (S, B, D, K)."""
    tensors = (x, masks, A, C)
    _kernel.check_inputs(what, tensors)
    lead = x.dim() - 2
    want = "x [B,D], masks [S,B,D], A and C [D,K]" if lead == 0 else (
        "x [R,B,D], masks [R,S,B,D], A and C [R,D,K]")
    if lead not in (0, 1) or masks.dim() != 3 + lead or A.dim() != 2 + lead:
        raise ValueError(f"{what}: want {want}, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    R = x.shape[:lead]
    B, D = x.shape[lead:]
    S = masks.shape[lead]
    K = A.shape[-1]
    if (masks.shape != (*R, S, B, D) or A.shape != (*R, D, K)
            or C.shape != (*R, D, K) or B < 1 or D < 1 or (R and R[0] < 1)):
        raise ValueError(f"{what}: want {want}, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if S < 1 or K < 1:
        raise ValueError(f"{what}: want at least one mask and one feature, "
                         f"got S={S}, K={K}")
    if R and R[0] > MAX_REPLICAS:
        raise ValueError(f"{what}: at most {MAX_REPLICAS} replicas a launch, "
                         f"got {R[0]}")
    # a copy would be needed where replica_slices is not the identity
    if not (_kernel.replica_slices(x, lead) is x
            and _kernel.replica_slices(masks, lead) is masks
            and A.is_contiguous() and C.is_contiguous()):
        raise ValueError(f"{what}: A and C must be contiguous, and so must "
                         "each replica's x and masks")
    return S, B, D, K


def _kernel_layout(x, masks, A, C):
    """The inputs as the kernels take them: x and masks with contiguous
    replica slices (a replica stride of 0 kept), A and C contiguous (each
    replica's own; one shared by the replicas is materialized)."""
    lead = x.dim() - 2
    return (_kernel.replica_slices(x, lead),
            _kernel.replica_slices(masks, lead), A.contiguous(),
            C.contiguous())


def _replica_args(x, masks):
    """(R or None, x and masks as replica views, their replica strides)."""
    if x.dim() == 2:
        return None, x, masks, 0, 0
    return x.shape[0], x, masks, x.stride(0), masks.stride(0)


def _embed_pool_fwd_kernel(x, masks, A, C, S, B, D, K, plan=None):
    """One forward launch for any number of replicas, tiled by `plan`
    (k_chunk, segments, rows_per_block, staged); by default `fwd_plan`'s
    for this card, given the SMs a replica has when R replicas share it."""
    R, x, masks, x_rs, m_rs = _replica_args(x, masks)
    n = R or 1
    lead = () if R is None else (R,)
    out = torch.empty((*lead, S, B, K), device=x.device, dtype=torch.float32)
    k_chunk, segments, rows, staged = plan or fwd_plan(
        B, D, K, max(1, _kernel.sm_count(x.device.index) // n))
    _fwd(x.device, x.data_ptr(), masks.data_ptr(), A.data_ptr(),
         C.data_ptr(), out.data_ptr(), S, B, D, K, k_chunk, segments, rows,
         int(staged), x_rs, m_rs, n)
    return out


def _embed_pool_bwd_kernel(x, masks, A, C, g, S, B, D, K, want_dx=True,
                           want_dm=True):
    dev = x.device
    R, x, masks, x_rs, m_rs = _replica_args(x, masks)
    n = R or 1
    lead = () if R is None else (R,)
    g = g.to(torch.float32).contiguous()
    if tuple(g.shape) != (*lead, S, B, K):
        raise ValueError(f"embed_pool_bwd: want g {list((*lead, S, B, K))}, "
                         f"got {list(g.shape)}")

    def out(shape, wanted=True):
        return (torch.empty((*lead, *shape), device=dev, dtype=torch.float32)
                if wanted else None)

    dx, dm = out((B, D), want_dx), out((S, B, D), want_dm)
    dA, dC = out((D, K)), out((D, K))
    _bwd(dev, x.data_ptr(), masks.data_ptr(), A.data_ptr(), C.data_ptr(),
         g.data_ptr(), dx.data_ptr() if dx is not None else None,
         dm.data_ptr() if dm is not None else None, dA.data_ptr(),
         dC.data_ptr(), S, B, D, K, x_rs, m_rs, n)
    return dx, dm, dA, dC


def embed_pool_bwd(x, masks, A, C, g, dmasks=True):
    """(dx, dmasks, dA, dC) of `embed_pool` given its cotangent g [S,B,K]
    (or [R,S,B,K] with a replica axis). dmasks is None when `dmasks=False`
    (the kernel then skips that write).

    CPU tensors: the plain version. CUDA tensors: the kernel, each launch
    counted (`ops/_kernel.launches`)."""
    if _kernel.on_cpu(x, masks, A, C, g):
        dx, dm, dA, dC = embed_pool_bwd_reference(x, masks, A, C, g)
        return dx, dm if dmasks else None, dA, dC
    S, B, D, K = _check(x, masks, A, C, "embed_pool_bwd")
    if g.device != x.device:
        raise ValueError(f"embed_pool_bwd: g lies on {g.device}, the inputs "
                         f"on {x.device}")
    return _embed_pool_bwd_kernel(x, masks, A, C, g, S, B, D, K,
                                  want_dm=dmasks)


class EmbedPool(torch.autograd.Function):
    """Forward B2f, backward B2b: the kernels on CUDA tensors, the plain
    versions on CPU tensors, with or without a replica axis. The vmap rule
    makes a vmapped call one call of this Function with the vmapped axis
    folded into the replica axis: x and masks that are not vmapped (an
    ensemble whose replicas share their rows or masks) are expanded without
    a copy, A and C are each replica's own."""

    @staticmethod
    def forward(x, masks, A, C):
        if _kernel.on_cpu(x, masks, A, C):
            return embed_pool_reference(x, masks, A, C)
        x, masks, A, C = _kernel_layout(x, masks, A, C)
        S, B, D, K = _check(x, masks, A, C, "embed_pool")
        return _embed_pool_fwd_kernel(x, masks, A, C, S, B, D, K)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.on_card = not _kernel.on_cpu(*inputs)
        if ctx.on_card:
            inputs = _kernel_layout(*inputs)
            *_, S, B, K = output.shape
            ctx.dims = (S, B, inputs[0].shape[-1], K)
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad
        if ctx.on_card:
            dx, dm, dA, dC = _embed_pool_bwd_kernel(
                *ctx.saved_tensors, g, *ctx.dims, want_dx=need[0],
                want_dm=need[1])
        else:
            dx, dm, dA, dC = embed_pool_bwd_reference(*ctx.saved_tensors, g)
        return tuple(t if n else None for t, n in zip((dx, dm, dA, dC), need))

    @staticmethod
    def vmap(info, in_dims, x, masks, A, C):
        V = info.batch_size
        # x [B, D]: 0, [R, B, D]: 1
        lead = _kernel.logical_dim(x, in_dims[0]) - 2
        folded = [_kernel.fold_replicas(t, d, V, lead)
                  for t, d in zip((x, masks, A, C), in_dims)]
        return _kernel.unfold_replicas(EmbedPool.apply(*folded), V, lead), 0


def embed_pool(x, masks, A, C):
    """agg[s,b,k] = sum_d masks[s,b,d] * relu(x[b,d]*A[d,k] + C[d,k]),
    differentiable in all four inputs (each replica's, with a replica
    axis).

    CPU tensors: the plain versions. CUDA tensors: the kernels, each launch
    counted (`ops/_kernel.launches`). The host's side of the forward
    (checks, layout, allocation, launch) is the span `ops.embed_pool`
    (`utils/tracing`)."""
    with tracing.span("ops.embed_pool"):
        return EmbedPool.apply(x, masks, A, C)

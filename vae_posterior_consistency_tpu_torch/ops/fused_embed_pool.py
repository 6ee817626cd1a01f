"""Fused EDDI embed + masked pool: the CUDA kernels' wrappers, their plain
versions and the autograd Function that ties them together.

    agg[s,b,k] = sum_d masks[s,b,d] * relu(x[b,d] * A[d,k] + C[d,k])

x [B, D], masks [S, B, D], A and C [D, K] (from
`models/layers._pointnet_affine`), all float32 -> agg [S, B, K] float32.

The kernels, in `csrc/embed_pool.cu`, replace the forward and backward
Pallas kernels of the JAX package (`ops/fused_embed_pool.py`, `_fwd_call`
and `_bwd_call`); the source's header says what bounds them and how they are
laid out. Each is one launch per call, reads A and C in place in their
[D, K] layout, and takes any S and K, as the JAX kernels do. The backward
recomputes the embed and returns dx, dmasks, dA, dC (dA and dC [D, K]).

`embed_pool` (differentiable, through `EmbedPool`) takes the plain versions,
`embed_pool_reference` and `embed_pool_bwd_reference`, for CPU tensors only.
For CUDA tensors it launches the kernels or raises; there is no switch back
to the plain versions. Forward launches count in `embed_pool.launches`,
backward launches in `embed_pool_bwd.launches`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vae_posterior_consistency_tpu_torch.ops import _build

#: values of k one forward block takes (csrc/embed_pool.cu `kChunkK`)
CHUNK_K = 16
#: warps of a forward block (csrc/embed_pool.cu `kWarps`)
WARPS = 8
#: bytes of A and C a forward block stages in shared memory at most; the H100
#: gives one block up to 227 KB. Beyond it the kernel reads them from global
#: memory.
STAGE_BYTES = 200 * 1024


def embed_pool_reference(x, masks, A, C):
    """The plain formulation: materialize the [B, D, K] embed, then pool."""
    emb = torch.relu(x[..., None] * A + C)  # [B, D, K]
    return torch.einsum("sbd,bdk->sbk", masks, emb)


def embed_pool_bwd_reference(x, masks, A, C, g):
    """The plain backward (the JAX package's `_bwd_kernel`): given
    g = d loss / d agg [S, B, K], returns (dx [B,D], dmasks [S,B,D],
    dA [D,K], dC [D,K]) with the embed recomputed."""
    pre = x[..., None] * A + C  # [B, D, K]
    act = (pre > 0.0).to(x.dtype)
    emb = torch.relu(pre)
    gsum = torch.einsum("sbd,sbk->bdk", masks, g)
    gact = gsum * act
    dx = torch.einsum("bdk,dk->bd", gact, A)
    dmasks = torch.einsum("bdk,sbk->sbd", emb, g)
    dA = torch.einsum("bd,bdk->dk", x, gact)
    dC = gact.sum(dim=0)
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


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _lib():
    lib = _build.library("embed_pool")
    fwd = lib.vpc_embed_pool_fwd
    fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                    + [ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    bwd = lib.vpc_embed_pool_bwd
    bwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                    + [ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    return lib, fwd, bwd


def _check(x, masks, A, C, what):
    """The kernels' contract on CUDA tensors; returns (S, B, D, K)."""
    tensors = (x, masks, A, C)
    devices = {t.device for t in tensors}
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"{what}: x, masks, A, C must lie on one CUDA "
                         f"device (or all on the CPU), got "
                         f"{sorted(map(str, devices))}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what}: the kernel takes float32 only, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if x.dim() != 2 or masks.dim() != 3 or A.dim() != 2:
        raise ValueError(f"{what}: want x [B,D], masks [S,B,D], A and C "
                         f"[D,K], got {[tuple(t.shape) for t in tensors]}")
    B, D = x.shape
    S = masks.shape[0]
    K = A.shape[1]
    if (masks.shape != (S, B, D) or A.shape != (D, K) or C.shape != (D, K)
            or B < 1 or D < 1):
        raise ValueError(f"{what}: want x [B,D], masks [S,B,D], A and C "
                         f"[D,K], got {[tuple(t.shape) for t in tensors]}")
    if S < 1 or K < 1:
        raise ValueError(f"{what}: want at least one mask and one feature, "
                         f"got S={S}, K={K}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: x, masks, A and C must be contiguous")
    return S, B, D, K


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _embed_pool_fwd_kernel(x, masks, A, C, S, B, D, K, plan=None):
    """One forward launch, tiled by `plan` (k_chunk, segments,
    rows_per_block, staged); by default `fwd_plan`'s for this card."""
    out = torch.empty((S, B, K), device=x.device, dtype=torch.float32)
    k_chunk, segments, rows, staged = plan or fwd_plan(
        B, D, K, _sm_count(x.device.index))
    lib, fwd, _ = _lib()
    code = fwd(x.data_ptr(), masks.data_ptr(), A.data_ptr(), C.data_ptr(),
               out.data_ptr(), S, B, D, K, k_chunk, segments, rows,
               int(staged), x.device.index, _stream(x))
    _build.check(lib, code, "embed_pool kernel launch")
    embed_pool.launches += 1
    return out


def _embed_pool_bwd_kernel(x, masks, A, C, g, S, B, D, K, want_dx=True,
                           want_dm=True):
    dev = x.device
    g = g.to(torch.float32).contiguous()
    if tuple(g.shape) != (S, B, K):
        raise ValueError(f"embed_pool_bwd: want g [S,B,K] = {(S, B, K)}, got "
                         f"{tuple(g.shape)}")
    lib, _, bwd = _lib()

    def out(shape, wanted=True):
        return (torch.empty(shape, device=dev, dtype=torch.float32)
                if wanted else None)

    dx, dm = out((B, D), want_dx), out((S, B, D), want_dm)
    dA, dC = out((D, K)), out((D, K))
    code = bwd(x.data_ptr(), masks.data_ptr(), A.data_ptr(), C.data_ptr(),
               g.data_ptr(), dx.data_ptr() if dx is not None else None,
               dm.data_ptr() if dm is not None else None, dA.data_ptr(),
               dC.data_ptr(), S, B, D, K, dev.index, _stream(x))
    _build.check(lib, code, "embed_pool backward kernel launch")
    embed_pool_bwd.launches += 1
    return dx, dm, dA, dC


def embed_pool_bwd(x, masks, A, C, g, dmasks=True):
    """(dx, dmasks, dA, dC) of `embed_pool` given its cotangent g [S,B,K].
    dmasks is None when `dmasks=False` (the kernel then skips that write).

    CPU tensors: the plain version. CUDA tensors: the kernel, counted in
    `embed_pool_bwd.launches`."""
    if all(t.device.type == "cpu" for t in (x, masks, A, C, g)):
        dx, dm, dA, dC = embed_pool_bwd_reference(x, masks, A, C, g)
        return dx, dm if dmasks else None, dA, dC
    S, B, D, K = _check(x, masks, A, C, "embed_pool_bwd")
    if g.device != x.device:
        raise ValueError(f"embed_pool_bwd: g lies on {g.device}, the inputs "
                         f"on {x.device}")
    return _embed_pool_bwd_kernel(x, masks, A, C, g, S, B, D, K,
                                  want_dm=dmasks)


embed_pool_bwd.launches = 0


class EmbedPool(torch.autograd.Function):
    """Forward B2f, backward B2b: the kernels on CUDA tensors, the plain
    versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, masks, A, C):
        if all(t.device.type == "cpu" for t in (x, masks, A, C)):
            ctx.save_for_backward(x, masks, A, C)
            ctx.on_card = False
            return embed_pool_reference(x, masks, A, C)
        S, B, D, K = _check(x, masks, A, C, "embed_pool")
        ctx.save_for_backward(x, masks, A, C)
        ctx.on_card = True
        ctx.dims = (S, B, D, K)
        return _embed_pool_fwd_kernel(x, masks, A, C, S, B, D, K)

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


def embed_pool(x, masks, A, C):
    """agg[s,b,k] = sum_d masks[s,b,d] * relu(x[b,d]*A[d,k] + C[d,k]),
    differentiable in all four inputs.

    CPU tensors: the plain versions. CUDA tensors: the kernels, each launch
    counted (`embed_pool.launches` forward, `embed_pool_bwd.launches`
    backward)."""
    return EmbedPool.apply(x, masks, A, C)


embed_pool.launches = 0

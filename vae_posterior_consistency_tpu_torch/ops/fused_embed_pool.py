"""Fused EDDI embed + masked pool: the CUDA kernels' wrappers, their plain
versions and the autograd Function that ties them together.

    agg[s,b,k] = sum_d masks[s,b,d] * relu(x[b,d] * A[d,k] + C[d,k])

x [B, D], masks [S, B, D], A and C [D, K] (from
`models/layers._pointnet_affine`), all float32 -> agg [S, B, K] float32.

The kernels, in `csrc/embed_pool.cu`, replace the forward and backward
Pallas kernels of the JAX package (`ops/fused_embed_pool.py`, `_fwd_call`
and `_bwd_call`); the source's header says what bounds them and how they are
laid out. The backward recomputes the embed and returns dx, dmasks, dA, dC.

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

#: the kernels keep S*K partial sums per thread in registers
MAX_S = 2
MAX_K = 32


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


@functools.cache
def _lib():
    lib = _build.library("embed_pool")
    fwd = lib.vpc_embed_pool_fwd
    fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                    + [ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    tiles = lib.vpc_embed_pool_bwd_tiles
    tiles.argtypes = [ctypes.c_int]
    tiles.restype = ctypes.c_int
    bwd = lib.vpc_embed_pool_bwd
    bwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                    + [ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    return lib, fwd, tiles, bwd


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
    if not 1 <= S <= MAX_S or not 1 <= K <= MAX_K:
        raise ValueError(f"{what}: the kernel takes S <= {MAX_S} masks "
                         f"and K <= {MAX_K} features, got S={S}, K={K}")
    if not (x.is_contiguous() and masks.is_contiguous()):
        raise ValueError(f"{what}: x and masks must be contiguous")
    return S, B, D, K


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _embed_pool_fwd_kernel(x, masks, a_t, c_t, S, B, D, K):
    out = torch.empty((S, B, K), device=x.device, dtype=torch.float32)
    lib, fwd, _, _ = _lib()
    code = fwd(x.data_ptr(), masks.data_ptr(), a_t.data_ptr(), c_t.data_ptr(),
               out.data_ptr(), S, B, D, K, x.device.index, _stream(x))
    _build.check(lib, code, "embed_pool kernel launch")
    embed_pool.launches += 1
    return out


def _embed_pool_bwd_kernel(x, masks, a_t, c_t, g, S, B, D, K, dmasks):
    dev = x.device
    g = g.to(torch.float32).contiguous()
    if tuple(g.shape) != (S, B, K):
        raise ValueError(f"embed_pool_bwd: want g [S,B,K] = {(S, B, K)}, got "
                         f"{tuple(g.shape)}")
    lib, _, tiles, bwd = _lib()
    dx = torch.empty((B, D), device=dev, dtype=torch.float32)
    dm = (torch.empty((S, B, D), device=dev, dtype=torch.float32)
          if dmasks else None)
    partial = torch.empty((tiles(B), 2, K, D), device=dev,
                          dtype=torch.float32)
    dac = torch.empty((2, K, D), device=dev, dtype=torch.float32)
    code = bwd(x.data_ptr(), masks.data_ptr(), a_t.data_ptr(), c_t.data_ptr(),
               g.data_ptr(), dx.data_ptr(),
               dm.data_ptr() if dm is not None else None,
               partial.data_ptr(), dac.data_ptr(), S, B, D, K, dev.index,
               _stream(x))
    _build.check(lib, code, "embed_pool backward kernel launch")
    embed_pool_bwd.launches += 1
    return dx, dm, dac[0].t(), dac[1].t()


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
    return _embed_pool_bwd_kernel(x, masks, A.t().contiguous(),
                                  C.t().contiguous(), g, S, B, D, K, dmasks)


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
        a_t = A.t().contiguous()  # [K, D]: reads over d coalesce
        c_t = C.t().contiguous()
        ctx.save_for_backward(x, masks, a_t, c_t)
        ctx.on_card = True
        ctx.dims = (S, B, D, K)
        return _embed_pool_fwd_kernel(x, masks, a_t, c_t, S, B, D, K)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad
        if ctx.on_card:
            x, masks, a_t, c_t = ctx.saved_tensors
            dx, dm, dA, dC = _embed_pool_bwd_kernel(
                x, masks, a_t, c_t, g, *ctx.dims, dmasks=need[1])
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

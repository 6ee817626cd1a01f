"""Fused EDDI embed + masked pool: the CUDA kernel's wrapper and plain version.

    agg[s,b,k] = sum_d masks[s,b,d] * relu(x[b,d] * A[d,k] + C[d,k])

x [B, D], masks [S, B, D], A and C [D, K] (from
`models/layers._pointnet_affine`), all float32 -> agg [S, B, K] float32.

The kernel, `csrc/embed_pool.cu`, replaces the forward Pallas kernel of the
JAX package (`ops/fused_embed_pool.py`, `_fwd_call`); its header says what
bounds it and how it is laid out. It is forward only: the backward is ported
with training, so the wrapper refuses inputs that need a gradient.

`embed_pool` takes the plain version, `embed_pool_reference`, for CPU tensors
only. For CUDA tensors it launches the kernel or raises; there is no switch
back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vae_posterior_consistency_tpu_torch.ops import _build

#: the kernel keeps S*K partial sums per thread in registers
MAX_S = 2
MAX_K = 32


def embed_pool_reference(x, masks, A, C):
    """The plain formulation: materialize the [B, D, K] embed, then pool."""
    emb = torch.relu(x[..., None] * A + C)  # [B, D, K]
    return torch.einsum("sbd,bdk->sbk", masks, emb)


@functools.cache
def _fwd():
    lib = _build.library("embed_pool")
    fn = lib.vpc_embed_pool_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def embed_pool(x, masks, A, C):
    """agg[s,b,k] = sum_d masks[s,b,d] * relu(x[b,d]*A[d,k] + C[d,k]).

    CPU tensors: the plain version. CUDA tensors: the kernel. Counts each
    kernel launch in `embed_pool.launches`."""
    tensors = (x, masks, A, C)
    if all(t.device.type == "cpu" for t in tensors):
        return embed_pool_reference(x, masks, A, C)
    devices = {t.device for t in tensors}
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"embed_pool: x, masks, A, C must lie on one CUDA "
                         f"device (or all on the CPU), got {sorted(map(str, devices))}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"embed_pool: the kernel takes float32 only, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if x.dim() != 2 or masks.dim() != 3 or A.dim() != 2:
        raise ValueError(f"embed_pool: want x [B,D], masks [S,B,D], A and C "
                         f"[D,K], got {[tuple(t.shape) for t in tensors]}")
    B, D = x.shape
    S = masks.shape[0]
    K = A.shape[1]
    if (masks.shape != (S, B, D) or A.shape != (D, K) or C.shape != (D, K)
            or B < 1 or D < 1):
        raise ValueError(f"embed_pool: want x [B,D], masks [S,B,D], A and C "
                         f"[D,K], got {[tuple(t.shape) for t in tensors]}")
    if not 1 <= S <= MAX_S or not 1 <= K <= MAX_K:
        raise ValueError(f"embed_pool: the kernel takes S <= {MAX_S} masks "
                         f"and K <= {MAX_K} features, got S={S}, K={K}")
    if not (x.is_contiguous() and masks.is_contiguous()):
        raise ValueError("embed_pool: x and masks must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "embed_pool: the CUDA kernel is forward only; its backward is "
            "ported with the training slice")
    a_t = A.t().contiguous()  # [K, D]: reads over d coalesce
    c_t = C.t().contiguous()
    out = torch.empty((S, B, K), device=x.device, dtype=torch.float32)
    lib, fn = _fwd()
    code = fn(x.data_ptr(), masks.data_ptr(), a_t.data_ptr(), c_t.data_ptr(),
              out.data_ptr(), S, B, D, K, x.device.index,
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "embed_pool kernel launch")
    embed_pool.launches += 1
    return out


embed_pool.launches = 0

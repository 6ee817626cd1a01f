"""Parameter dicts and plain apply functions (port of the JAX package's
`nn/core.py`).

Parameters are nested dicts of tensors in the JAX layout: a dense layer is
{"w": [fan_in, fan_out], "b": [fan_out]} and y = x @ w + b, so a checkpoint
of either package maps leaf for leaf. Initializers reproduce torch's defaults,
which the reference relies on; they draw from an explicit generator on an
explicit device.

Mixed precision (`compute_dtype`, the JAX package's `nn/core.py:43-79`):
under 'bfloat16' `dense` narrows both operands of its product to bf16 and
accumulates in float32, which is also its output; parameters, optimizer
state and all elementwise math stay float32.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Sequence

import torch

Params = dict


def _uniform(generator, shape, bound, device):
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return u * (2.0 * bound) - bound


def torch_linear_init(generator: torch.Generator, fan_in: int, fan_out: int,
                      device="cuda") -> Params:
    """torch.nn.Linear default init: W, b ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    return {
        "w": _uniform(generator, (fan_in, fan_out), bound, device),
        "b": _uniform(generator, (fan_out,), bound, device),
    }


def xavier_uniform(generator: torch.Generator, shape, device="cuda"):
    """torch.nn.init.xavier_uniform_ on a 2D tensor (EDDI per-feature
    embeddings, reference: src/models/VAE.py:49-52)."""
    fan_in, fan_out = shape[-2], shape[-1]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(generator, shape, bound, device)


class _DtypeStack(threading.local):
    def __init__(self):
        self.stack = ["float32"]


#: the active product dtype of this thread; a model function runs eagerly,
#: so the choice holds while it runs, and its backward follows the products
#: its forward recorded
_COMPUTE_DTYPE = _DtypeStack()


class compute_dtype:
    """Context manager selecting the operand dtype of `dense`'s product:
    'float32' (the default) or 'bfloat16' (bf16 operands, float32
    accumulation and output). `models/registry.get_model` runs a model's
    `train_loss` and `eval_step` under it for `RunConfig.compute_dtype`."""

    def __init__(self, dtype: str = "float32"):
        self.dtype = dtype

    def __enter__(self):
        _COMPUTE_DTYPE.stack.append(self.dtype)

    def __exit__(self, *exc):
        _COMPUTE_DTYPE.stack.pop()


def active_dtype() -> str:
    """The product dtype `dense` uses now."""
    return _COMPUTE_DTYPE.stack[-1]


def dense(params: Params, x):
    """y = x @ W + b, accumulated in float32. Under
    compute_dtype('bfloat16') both operands are rounded to bf16 first
    (`bf16_product`), as the JAX package's `dot(bf16(x), bf16(W),
    preferred_element_type=f32) + b`."""
    if active_dtype() == "bfloat16":
        return (bf16_product(x.to(torch.bfloat16),
                             params["w"].to(torch.bfloat16))
                + params["b"])
    return torch.matmul(x, params["w"]) + params["b"]


def bf16_product(a, b):
    """a @ b of bf16 a [..., N, K] and b [K, M] (or [..., K, M], leading
    axes broadcast) as float32, each operand's gradient rounded to bf16.

    CPU tensors: the plain version, the product of the operands widened to
    float32 (exact products, float32 sums; autograd's backward of the
    widening rounds each gradient to bf16). CUDA tensors: `_Bf16Product`,
    the bf16 tensor cores with a float32 output."""
    if a.device.type == "cpu":
        return torch.matmul(a.float(), b.float())
    return _Bf16Product.apply(a, b)


def _bf16_mm(a, b):
    """One cuBLAS product of bf16 operands with a float32 output (no
    rounding of the sums to bf16), counted in `bf16_product.launches`."""
    bf16_product.launches += 1
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b,
                       out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*lead, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*lead, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    out = torch.bmm(a3, b3, out_dtype=torch.float32)
    return out.reshape(*lead, a.shape[-2], b.shape[-1])


bf16_product.launches = 0


class _Bf16Product(torch.autograd.Function):
    """`bf16_product` on the card. The backward rounds the float32
    cotangent g to bf16 once and forms each operand's gradient as one more
    bf16 product with a float32 output, rounded to bf16 (ROADMAP C.4.33:
    the CPU's plain version keeps g in float32 there, so the two differ by
    about one bf16 ulp of g in each term). A broadcast operand's gradient is
    summed in float32 before its rounding. The vmap rule moves the vmapped
    axes in front of the operands' own leading axes, so a vmapped call
    (`parallel/sweep`, the AL ensemble) is one product."""

    @staticmethod
    def forward(a, b):
        return _bf16_mm(a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(torch.bfloat16)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _bf16_mm(g, b.mT).sum_to_size(a.shape).to(torch.bfloat16)
        if ctx.needs_input_grad[1]:
            if b.dim() == 2:
                K, M = b.shape
                db = _bf16_mm(a.reshape(-1, K).mT, g.reshape(-1, M))
            else:
                db = _bf16_mm(a.mT, g).sum_to_size(b.shape)
            db = db.to(torch.bfloat16)
        return da, db

    @staticmethod
    def vmap(info, in_dims, a, b):
        ad, bd = in_dims
        if bd is None:  # a shared b: the vmapped axis joins a's rows
            return _Bf16Product.apply(a.movedim(ad, 0), b), 0
        a = a.movedim(ad, 0) if ad is not None else a.unsqueeze(0)
        b = b.movedim(bd, 0)
        n = max(a.dim(), b.dim()) - 1
        a = a.reshape(a.shape[0], *[1] * (n - a.dim() + 1), *a.shape[1:])
        b = b.reshape(b.shape[0], *[1] * (n - b.dim() + 1), *b.shape[1:])
        return _Bf16Product.apply(a, b), 0


def hardtanh(x, min_val: float, max_val: float):
    """torch.nn.Hardtanh with jnp.clip's gradient: 1 inside, 0.5 at a
    bound, 0 outside (`torch.clamp` and `F.hardtanh` pass all of it at a
    bound). The bounds are 0-d CPU tensors, which a CUDA op takes as
    scalars (reference: src/models/VAE.py:2363)."""
    lo = torch.tensor(min_val, dtype=x.dtype)
    hi = torch.tensor(max_val, dtype=x.dtype)
    return torch.minimum(torch.maximum(x, lo), hi)


def param_count(params) -> int:
    """The number of scalars in nested parameters (dicts, lists)."""
    if isinstance(params, dict):
        params = params.values()
    if isinstance(params, torch.Tensor):
        return params.numel()
    return sum(param_count(p) for p in params)


ACTIVATIONS: dict[str, Callable] = {
    "relu": torch.relu,
    "elu": torch.nn.functional.elu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softplus": torch.nn.functional.softplus,
    "identity": lambda x: x,
}


def mlp_init(generator: torch.Generator, sizes: Sequence[int],
             device="cuda") -> Params:
    """An MLP of len(sizes)-1 Linear layers, keyed layer0, layer1, ..."""
    return {
        f"layer{i}": torch_linear_init(generator, sizes[i], sizes[i + 1],
                                       device)
        for i in range(len(sizes) - 1)
    }


def mlp_apply(params: Params, x, hidden_act: str = "relu",
              final_act: str = "identity"):
    """Apply an MLP: `hidden_act` between layers, `final_act` on the output."""
    n = len(params)
    act = ACTIVATIONS[hidden_act]
    for i in range(n):
        x = dense(params[f"layer{i}"], x)
        if i < n - 1:
            x = act(x)
    return ACTIVATIONS[final_act](x)

"""Parameter dicts and plain apply functions (port of the JAX package's
`nn/core.py`).

Parameters are nested dicts of tensors in the JAX layout: a dense layer is
{"w": [fan_in, fan_out], "b": [fan_out]} and y = x @ w + b, so a checkpoint
of either package maps leaf for leaf. Initializers reproduce torch's defaults,
which the reference relies on; they draw from an explicit generator on an
explicit device.
"""

from __future__ import annotations

import math
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


def dense(params: Params, x):
    """y = x @ W + b in float32."""
    return torch.matmul(x, params["w"]) + params["b"]


def hardtanh(x, min_val: float, max_val: float):
    """torch.nn.Hardtanh with jnp.clip's gradient: 1 inside, 0.5 at a
    bound, 0 outside (`torch.clamp` and `F.hardtanh` pass all of it at a
    bound). The bounds are 0-d CPU tensors, which a CUDA op takes as
    scalars (reference: src/models/VAE.py:2363)."""
    lo = torch.tensor(min_val, dtype=x.dtype)
    hi = torch.tensor(max_val, dtype=x.dtype)
    return torch.minimum(torch.maximum(x, lo), hi)


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

"""Inputs made from `--seed`: generators, tables, MCAR masks and weights,
all on the device and in a few large calls. The same seed gives the same
inputs; the system and the reference get the same values."""

from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of `seed`, `tags` naming the use."""
    digest = hashlib.sha256(repr((int(seed), tags)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, *tags, device="cuda") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def table(gen, n: int, D: int, device) -> torch.Tensor:
    """An [n, D] float32 table, min-max scaled per column to [0, 1] as the
    loaders scale the UCI tables (each column holds a 0 and a 1)."""
    t = torch.rand((n, D), generator=gen, device=device)
    lo, hi = t.amin(0, keepdim=True), t.amax(0, keepdim=True)
    return (t - lo) / (hi - lo)


def mcar(gen, shape, missing_rate, device) -> torch.Tensor:
    """A float32 MCAR observation mask (1 = observed), each cell missing
    with probability missing_rate / 100."""
    u = torch.rand(shape, generator=gen, device=device)
    return (u >= missing_rate / 100.0).to(torch.float32)


def weights(specs, gen, device, scale=None) -> dict:
    """Flat parameters {key: tensor} for `specs` [(key, shape, bound)]:
    one uniform draw for all of them, each leaf U(-bound, bound), the
    leaves named in `scale` {key: factor} multiplied by it."""
    sizes = [torch.Size(shape).numel() for _, shape, _ in specs]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (key, shape, bound), n in zip(specs, sizes):
        leaf = u[off:off + n].reshape(shape) * (2.0 * bound) - bound
        out[key] = leaf * (scale or {}).get(key, 1.0)
        off += n
    return out


def copy(params: dict) -> dict:
    return {k: v.detach().clone() for k, v in params.items()}

"""The least time of each custom kernel on the card, from its shapes: its
bytes over the memory rate or its float32 operations over the float32
rate, whichever is larger. Each input byte is counted read once and each
output byte written once. Frozen from the port's `chip_smoke.py`
(`_bound`, `embed_pool_bound_ms`, `embed_pool_bwd_bound_ms`,
`fused_posterior_bound_ms`, `fused_posterior_bwd_bound_ms`), so that a
change to the program cannot move the yardstick."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def bound_s(nbytes, ops):
    """(least seconds, 'bytes' or 'operations')."""
    t_bytes = nbytes / PEAKS["bytes_per_s"]
    t_ops = ops / PEAKS["float32_flops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def embed_pool_fwd(S, B, D, K):
    """B2f: reads x, masks, A, C and writes the output once; (3+2S)*B*D*K
    operations."""
    nbytes = 4 * (B * D + S * B * D + 2 * D * K + S * B * K)
    return bound_s(nbytes, (3 + 2 * S) * B * D * K)


def embed_pool_bwd(S, B, D, K, dx=True, dmasks=True):
    """B2b: reads x, masks, A, C, g and writes dx and dmasks (each if
    asked), dA, dC once; (6+2S)*B*D*K operations for dA and dC, 2 more a
    cell for dx and 1+2S for dmasks."""
    nbytes = 4 * (B * D + S * B * D + 2 * D * K + S * B * K
                  + (B * D if dx else 0) + (S * B * D if dmasks else 0)
                  + 2 * D * K)
    ops = (6 + 2 * S + (2 if dx else 0) + (1 + 2 * S if dmasks else 0))
    return bound_s(nbytes, ops * B * D * K)


def fused_posterior_fwd(B, L):
    """B1: reads six [B,L] inputs, writes z_q, z_p and three sums once;
    about 31 operations a cell."""
    return bound_s(4 * (8 * B * L + 3), 31 * B * L)


def fused_posterior_bwd(B, L, eps=False):
    """B1's backward: reads six [B,L] inputs, dz_q, dz_p and the three KL
    cotangents, writes the four statistics' gradients (and the two eps
    gradients with `eps`) once; about 44 operations a cell, 1 more for
    each eps gradient."""
    n_out = 6 if eps else 4
    return bound_s(4 * ((8 + n_out) * B * L + 3), (46 if eps else 44) * B * L)


#: kernel -> (its bound function, the substring of its name in a trace)
KERNELS = {
    "embed_pool_fwd": (embed_pool_fwd, "embed_pool_fwd_kernel"),
    "embed_pool_bwd": (embed_pool_bwd, "embed_pool_bwd_kernel"),
    "fused_posterior_fwd": (fused_posterior_fwd, "fused_posterior_kernel"),
    "fused_posterior_bwd": (fused_posterior_bwd,
                            "fused_posterior_bwd_kernel"),
}


def least_seconds(launches) -> dict:
    """{kernel: (summed least seconds, {'bytes': n, 'operations': n})}
    over `launches` [(kernel, shape kwargs, count)]."""
    out = {}
    for kernel, shape, count in launches:
        t, what = KERNELS[kernel][0](**shape)
        total, by = out.get(kernel, (0.0, {"bytes": 0, "operations": 0}))
        by[what] += count
        out[kernel] = (total + t * count, by)
    return out


def roofline_pct(ctx, names):
    """The kernels `names` against their roofline, in percent: the least
    time of the window's launches of them (`ctx['launches']`) over their
    device time in the trace; None where the trace holds none of them."""
    launches = [x for x in ctx.get("launches", []) if x[0] in names]
    device = ctx["window"].device_seconds(*(KERNELS[k][1] for k in names))
    if not launches or device <= 0:
        return None
    return 100.0 * sum(t for t, _ in least_seconds(launches).values()) / device

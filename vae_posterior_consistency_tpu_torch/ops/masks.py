"""Missingness masks for training (port of the JAX package's `ops/masks.py`,
the MCAR part).

Semantics (reference: src/utils/utils.py:36-39, src/experiment_main/
train.py:31-58): a cell is observed (1.0) when its uniform draw u satisfies
u < 1 - rate/100, with the threshold computed in float32 as the JAX package
computes it. The uniforms are explicit: each function takes them as a tensor
(`uniforms`) or draws them from a `torch.Generator` (`generator`), exactly
one of the two, so a test can hand in the very uniforms JAX drew.
"""

from __future__ import annotations

import numpy as np
import torch


def _keep_threshold(missing_rate) -> float:
    """1 - rate/100 rounded as float32 arithmetic rounds it, as a Python
    float (exact): comparing a float32 tensor with it needs no copy to the
    device, which would wait for the device's queue to drain."""
    rate = np.float32(missing_rate) / np.float32(100.0)
    return float(np.float32(1.0) - rate)


def _uniforms(shape, device, uniforms, generator):
    if (uniforms is None) == (generator is None):
        raise ValueError("pass exactly one of uniforms, generator")
    if uniforms is None:
        return torch.rand(shape, generator=generator, device=device,
                          dtype=torch.float32)
    if tuple(uniforms.shape) != tuple(shape):
        raise ValueError(f"uniforms of shape {tuple(uniforms.shape)}, want "
                         f"{tuple(shape)}")
    return uniforms


def mcar_mask(shape, missing_rate, *, uniforms=None, generator=None,
              device="cuda") -> torch.Tensor:
    """Element-wise Bernoulli MCAR observation mask, float32, 1.0 = observed:
    each cell is observed with probability 1 - missing_rate/100."""
    u = _uniforms(shape, device, uniforms, generator)
    return (u < _keep_threshold(missing_rate)).to(torch.float32)


def sub_mask(mask, p_missingness, *, uniforms=None, generator=None):
    """The posterior-consistency `mask_p`: `mask` impoverished by an extra
    MCAR draw, mask * Bernoulli(1 - p_missingness/100)
    (reference: src/experiment_main/train.py:54-55)."""
    return mask * mcar_mask(mask.shape, p_missingness, uniforms=uniforms,
                            generator=generator, device=mask.device)


def train_masks(info, cfg, mask, *, uniforms=None, generator=None):
    """The reference's per-batch training-mask dispatch
    (src/experiment_main/train.py:31-58), returning (eff_mask, mask_p):
      reg families:  mask_p = MCAR(p_missingness) * mask, eff = mask
      plain vanilla: eff = mask, mask_p = ones (no uniforms are read)
    `_with_drop` types need the EDDI dropout mask, which comes later."""
    if info.regularized:
        return mask, sub_mask(mask, cfg.p_missingness, uniforms=uniforms,
                              generator=generator)
    if info.with_drop:
        raise NotImplementedError(
            f"vae_type {info.raw!r}: the `_with_drop` training mask "
            "(eddi_drop_mask) is not ported yet; it comes with the EDDI "
            "drop-mask slice (ROADMAP A.12)")
    return mask, torch.ones_like(mask)

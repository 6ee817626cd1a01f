"""Missingness masks (port of the JAX package's `ops/masks.py`: the MCAR and
EDDI drop masks of training, and the MNAR generators).

Semantics (reference: src/utils/utils.py:36-45, src/experiment_main/
train.py:31-58): an MCAR cell is observed (1.0) when its uniform draw u
satisfies u < 1 - rate/100, with the threshold computed in float32 as the
JAX package computes it; an EDDI drop-mask cell is kept when its second
uniform u2 satisfies u2 < 1 - min(u1, 0.99), u1 its first. The uniforms are
explicit: each function takes them as a tensor (`uniforms`) or draws them
from a `torch.Generator` (`generator`), exactly one of the two, so a test
can hand in the very uniforms JAX drew. The MNAR generators draw nothing:
they are functions of the data (reference: src/utils/utils.py:48-105).
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


def eddi_drop_mask(shape, *, uniforms=None, generator=None,
                   device="cuda") -> torch.Tensor:
    """EDDI training dropout mask, float32, 1.0 = kept: each cell is kept
    with probability 1 - min(U(0,1), 0.99), two uniforms a cell
    (reference: src/utils/utils.py:42-45). `uniforms` is [2, *shape]: row 0
    the draw of the keep probability, row 1 the keep draw."""
    u = _uniforms((2, *shape), device, uniforms, generator)
    temp = torch.clamp(u[0], max=0.99)
    return (u[1] < 1.0 - temp).to(torch.float32)


def sub_mask(mask, p_missingness, *, uniforms=None, generator=None):
    """The posterior-consistency `mask_p`: `mask` impoverished by an extra
    MCAR draw, mask * Bernoulli(1 - p_missingness/100)
    (reference: src/experiment_main/train.py:54-55)."""
    return mask * mcar_mask(mask.shape, p_missingness, uniforms=uniforms,
                            generator=generator, device=mask.device)


def toy_mask(batch_size: int, missing_rate, *, uniforms=None,
             generator=None, device="cuda") -> torch.Tensor:
    """The 2-column toy mask [B, 2]: column 0 observed everywhere, column 1
    on the ceil(B * (1 - rate/100)) rows of smallest uniform, a random
    subset (reference: src/utils/utils.py:24-33). `uniforms` is [B]."""
    n_given = int(-(-batch_size * (1.0 - float(missing_rate) / 100.0) // 1))
    u = _uniforms((batch_size,), device, uniforms, generator)
    perm = torch.argsort(u)
    col1 = torch.zeros(batch_size, dtype=torch.float32, device=u.device)
    col1[perm[:n_given]] = 1.0
    return torch.stack([torch.ones_like(col1), col1], dim=1)


def train_masks(info, cfg, mask, *, uniforms=None, generator=None):
    """The reference's per-batch training-mask dispatch
    (src/experiment_main/train.py:31-58), returning (eff_mask, mask_p):
      reg families:      mask_p = MCAR(p_missingness) * mask, eff = mask
                         (uniforms shaped like `mask`)
      with_drop vanilla: eff = mask * eddi_drop_mask, mask_p = ones
                         (uniforms [2, *mask.shape])
      plain vanilla:     eff = mask, mask_p = ones (no uniforms are read)"""
    if info.regularized:
        return mask, sub_mask(mask, cfg.p_missingness, uniforms=uniforms,
                              generator=generator)
    if info.with_drop:
        drop = eddi_drop_mask(tuple(mask.shape), uniforms=uniforms,
                              generator=generator, device=mask.device)
        return mask * drop, torch.ones_like(mask)
    return mask, torch.ones_like(mask)


def _mnar_threshold(x, stat: str, half: bool) -> torch.Tensor:
    """Hide (0.0) the cells above their column's statistic, the mean or the
    variance with ddof=1, in the first D//2 columns (`half`) or in all of
    them; the other cells are observed (1.0)."""
    n, d = x.shape
    d_sel = d // 2 if half else d
    cols = x[:, :d_sel]
    thresh = (torch.mean(cols, dim=0) if stat == "mean"
              else torch.var(cols, dim=0, correction=1))
    mask = torch.ones((n, d), dtype=torch.float32, device=x.device)
    mask[:, :d_sel] = (~(cols > thresh)).to(torch.float32)
    return mask


def mnar_mask_mean_half(x) -> torch.Tensor:
    """Hide cells above the column mean in the first D/2 features
    (reference: src/utils/utils.py:48-60)."""
    return _mnar_threshold(x, "mean", half=True)


def mnar_mask_mean_all(x) -> torch.Tensor:
    """Hide cells above the column mean in all features
    (reference: src/utils/utils.py:63-75)."""
    return _mnar_threshold(x, "mean", half=False)


def mnar_mask_var_all(x) -> torch.Tensor:
    """Hide cells above the column variance in all features
    (reference: src/utils/utils.py:78-90)."""
    return _mnar_threshold(x, "var", half=False)


def mnar_mask_var_half(x) -> torch.Tensor:
    """Hide cells above the column variance in the first D/2 features
    (reference: src/utils/utils.py:93-105)."""
    return _mnar_threshold(x, "var", half=True)


MNAR_GENERATORS = {
    "half_features_mnar_mean": mnar_mask_mean_half,
    "all_features_mnar_mean": mnar_mask_mean_all,
    "all_features_mnar_var": mnar_mask_var_all,
    "half_features_mnar_var": mnar_mask_var_half,
}

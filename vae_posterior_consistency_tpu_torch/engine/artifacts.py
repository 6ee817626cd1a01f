"""Result artifacts: the reference's paths and `.pt` scalars, and a
structured `metrics.jsonl` (port of the JAX package's `engine/artifacts.py`:
the VAE, MIWAE and MNAR evaluators' paths and the active-learning ones).

The reference writes every headline metric as a torch-saved tensor in a
deep, name-mangled directory tree (reference:
src/experiment_main/evaluate.py:247-297, 58-69). The paths here are the JAX
package's character for character, and each file holds what the JAX package
writes there: a 0-d float64 tensor for a Python float, and the float32
tensors of an active-learning episode (`active_learning_paths`).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.engine.checkpoint import family_dir


def strip_digits(s: str) -> str:
    return "".join(c for c in s if not c.isdigit())


def _base(cfg: RunConfig, root: str, sub: str) -> str:
    return os.path.join(root, cfg.experiment_type, cfg.data_type, sub)


def save_tensor(value, path: str) -> None:
    """torch.save `value` at `path`, parents made. A tensor is saved as it
    is; anything else goes through numpy first, as in the JAX package, so a
    Python float becomes a 0-d float64 tensor."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(np.array(value))
    torch.save(value, path)


def log_metric(cfg: RunConfig, name: str, value, stage: str = "",
               root: str = "experiments") -> None:
    """Append one metric record to `<root>/<experiment_type>/<data_type>/
    metrics.jsonl` (the JAX package's record, field for field)."""
    path = os.path.join(root, cfg.experiment_type, cfg.data_type,
                        "metrics.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = np.asarray(value)
    rec = {
        "time": time.time(),
        "vae_type": cfg.vae_type,
        "stage": stage,
        "metric": name,
        "value": float(arr.reshape(-1)[0]) if arr.size == 1 else arr.tolist(),
        "alpha": cfg.alpha,
        "p_missingness": cfg.p_missingness,
        "missing_rate": cfg.missing_rate,
        "reg_type": cfg.reg_type,
    }
    with open(path, "a") as fh:
        fh.write(json.dumps(rec) + "\n")


def eval_vae_paths(cfg: RunConfig, stage: str,
                   root: str = "experiments") -> dict:
    """The four MCAR evaluation artifacts of one split: rmse, elbo, negll,
    negll_imp (reference: src/experiment_main/evaluate.py:247-297)."""
    fam = family_dir(cfg.vae_type)
    rest = _base(cfg, root, "rest")
    elbos = _base(cfg, root, "elbos")
    if "vanilla" in cfg.vae_type:
        tail = f"_{cfg.missing_rate}_missing_rate_test.pt"
        return {
            "rmse": os.path.join(rest, fam,
                                 f"{stage}_{cfg.vae_type}_rmse{tail}"),
            "elbo": os.path.join(elbos, fam,
                                 f"{stage}_{cfg.vae_type}_vae_elbo{tail}"),
            "negll": os.path.join(
                rest, fam, f"{stage}_{cfg.vae_type}_negative_llh{tail}"),
            "negll_imp": os.path.join(
                rest, fam,
                f"{stage}_{cfg.vae_type}_negative_llh_imputed{tail}"),
        }
    mid = f"_{cfg.alpha}_{cfg.p_missingness}_{cfg.reg_type}"
    tail = f"{mid}_{cfg.missing_rate}_missing_rate_full_reg_test.pt"
    return {
        "rmse": os.path.join(rest, fam, f"{stage}_{cfg.vae_type}_rmse{tail}"),
        "elbo": os.path.join(elbos, fam,
                             f"{stage}_{cfg.vae_type}_vae_elbo{tail}"),
        "negll": os.path.join(
            rest, fam, f"{stage}_{cfg.vae_type}_negative_llh_q{tail}"),
        "negll_imp": os.path.join(
            rest, fam, f"{stage}_{cfg.vae_type}_negative_llh_q_imputed{tail}"),
    }


def eval_miwae_paths(cfg: RunConfig, stage: str,
                     root: str = "experiments") -> dict:
    """The MIWAE evaluator's one artifact of a split, its rmse (reference:
    src/experiment_main/evaluate.py:120-133, with the hard-coded
    '50_missing_rate' of both branches)."""
    fam = family_dir(cfg.vae_type)
    rest = _base(cfg, root, "rest")
    if "vanilla" in cfg.vae_type:
        name = f"{stage}_{cfg.vae_type}_rmse_50_missing_rate_test.pt"
    else:
        name = (f"{stage}_{cfg.vae_type}_rmse_{cfg.alpha}_{cfg.p_missingness}"
                f"_{cfg.reg_type}_full_reg_50_missing_rate_test.pt")
    return {"rmse": os.path.join(rest, fam, name)}


def eval_mnar_paths(cfg: RunConfig, root: str = "experiments") -> dict:
    """The MNAR evaluator's one artifact, its rmse (reference:
    src/experiment_main/evaluate.py:58-69). Its folder is the whole
    vae_type with every digit stripped, where the other savers use
    `family_dir`."""
    fam = strip_digits(cfg.vae_type)
    rest = _base(cfg, root, "rest")
    if "vanilla" in cfg.vae_type:
        name = f"{cfg.vae_type}_rmse_{cfg.not_miwae_type}_large_batch_test.pt"
    else:
        name = (f"{cfg.vae_type}_rmse_{cfg.alpha}_{cfg.p_missingness}_"
                f"{cfg.reg_type}_full_reg_large_batch_v2_test.pt")
    return {"rmse": os.path.join(rest, fam, name)}


def active_learning_paths(cfg: RunConfig, root: str = "experiments") -> dict:
    """The four tensors of an active-learning episode: information_curve,
    action, R_hist, im (reference: src/experiment_main/evaluate.py:
    460-511)."""
    fam = family_dir(cfg.vae_type)
    rest = os.path.join(_base(cfg, root, "rest"), fam)
    if "vanilla" in cfg.vae_type:
        pre = f"{cfg.vae_type}_{cfg.missing_rate}_missing_rate"
        return {
            "information_curve": os.path.join(
                rest, f"{pre}_UCI_information_curve_CHAI_default_test.pt"),
            "action": os.path.join(
                rest, f"{pre}__UCI_action_CHAI_default_test.pt"),
            "R_hist": os.path.join(
                rest, f"{pre}__UCI_R_hist_CHAI_default_test.pt"),
            "im": os.path.join(rest, f"{pre}__UCI_im_CHAI_default_test.pt"),
        }
    mid = (f"_{cfg.alpha}_{cfg.p_missingness}_{cfg.reg_type}_"
           f"{cfg.missing_rate}_missing_rate_default_full_reg_test.pt")
    return {name: os.path.join(rest, f"{cfg.vae_type}_UCI_{name}_CHAI{mid}")
            for name in ("information_curve", "action", "R_hist", "im")}

"""Data-parallel evaluation over a device mesh (port of the JAX package's
`engine/evaluate_sharded.py`).

Each of cfg.M Monte-Carlo reps evaluates a whole split at once: the rows,
zero-padded to a multiple of dp (a padded row is fully observed and weighs
0), are cut into dp equal shards, each rank runs the model's row-wise
`eval_step` on its shard, and the ranks' weighted sums (squared error over
the holes, the hole count, the row loss, negl, negl_imp and the weight) are
summed over the dp group. A rep's metrics are the JAX package's
whole-split aggregates, rmse = sqrt(se / max(holes, 1)) and the
weight-averaged row means, averaged over the reps. This is the JAX
package's deviation from `engine/evaluate.eval_vae`, kept: the mean of
per-batch statistics there, whole-split aggregates here.

The parameters are replicated (JAX places them on P()), so tp plays no
part. Noise: `noise(kind, rep, 0, shape)`; a rep draws "mask_p" uniforms
for a fresh `mask_p` (ops/masks.sub_mask) for every family, then the
family's `eval_noise` other than "mask_p", each at the padded split's
global shape, and each rank takes its rows (`ModelDef.eval_noise_rows`).
The default source is `train.GeneratorNoise(cfg.seed + 1, device)`, made
anew for each split, as the JAX package keys both splits PRNGKey(seed + 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.engine import checkpoint
from vae_posterior_consistency_tpu_torch.engine.evaluate import (
    _save_eval_artifacts,
)
from vae_posterior_consistency_tpu_torch.engine.train import (
    GeneratorNoise,
    load_trained,
)
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.ops import masks
from vae_posterior_consistency_tpu_torch.parallel import multihost
from vae_posterior_consistency_tpu_torch.parallel.mesh import (
    RankRows,
    rows_of,
)


def _rep_sums(model, cfg: RunConfig, params, x, mask, w, noise,
              rep: int) -> torch.Tensor:
    """This rank's weighted sums of one rep over its rows (x, mask, w):
    [squared error over the holes, holes, loss, negl, negl_imp, weight],
    its draws taken from the global draws by `noise` (a `RankRows`)."""
    u = noise("mask_p", rep, 0, tuple(mask.shape))
    mask_p = masks.sub_mask(mask, cfg.p_missingness, uniforms=u.to(x.device))
    drawn = {kind: noise(kind, rep, 0, shape).to(x.device)
             for kind, shape in model.eval_noise(cfg, *x.shape).items()
             if kind != "mask_p"}
    out = model.eval_step(params, x, mask, mask_p, drawn["eps"], cfg)
    hole = (1.0 - mask) * w[:, None]
    return torch.stack([
        torch.sum(torch.square((out["x_imputed"] - x) * hole)),
        torch.sum(hole),
        torch.sum(out["row_loss"] * w),
        torch.sum(out["row_negl"] * w),
        torch.sum(out["row_negl_imp"] * w),
        torch.sum(w),
    ])


def eval_split_sharded(params, x, mask, cfg: RunConfig, mesh, noise=None,
                       num_samples: Optional[int] = None,
                       n_reps: int = 1) -> dict:
    """One split over `n_reps` reps, rows dp-sharded over `mesh`; every
    rank calls it and gets the same {loss, negl, negl_imp, rmse} (the
    reps' mean of the whole-split aggregates). `num_samples` replaces
    cfg.valid_k (the importance samples of the MIWAE families). The
    default `noise` is `GeneratorNoise(cfg.seed + 7, device)`, as JAX keys
    PRNGKey(seed + 7) here."""
    if num_samples:
        cfg = dataclasses.replace(cfg, valid_k=num_samples)
    model = get_model(cfg)
    device = mesh.device
    x = torch.as_tensor(x).to(device=device, dtype=torch.float32)
    mask = torch.as_tensor(mask).to(device=device, dtype=torch.float32)
    n = x.shape[0]
    rows = rows_of(mesh, n)
    x, mask = rows.take(rows.pad(x)), rows.take(rows.pad(mask, 1.0))
    noise = GeneratorNoise(cfg.seed + 7, device) if noise is None else noise
    ranked = RankRows(noise, {"mask_p": 0, **model.eval_noise_rows(cfg)},
                      rows.dp, rows.r)
    params = checkpoint.on_device(params, device)
    with torch.no_grad():
        sums = torch.stack([
            _rep_sums(model, cfg, params, x, mask, rows.weights(device),
                      ranked, m) for m in range(n_reps)])
        dist.all_reduce(sums, group=mesh.group("dp"))
        se, holes, loss, negl, negl_imp, weight = sums.unbind(1)
        per_rep = {
            "rmse": torch.sqrt(se / torch.clamp(holes, min=1.0)),
            "loss": loss / weight,
            "negl": negl / weight,
            "negl_imp": negl_imp / weight,
        }
        # sorted key order, as JAX's tree_map returns the dict
        return {k: per_rep[k].mean().item() for k in sorted(per_rep)}


def eval_vae_sharded(dataset, cfg: RunConfig, mesh,
                     params: Optional[dict] = None,
                     experiments_root: str = "experiments", noise=None,
                     save: bool = True) -> dict:
    """The mesh path's `engine/evaluate.eval_vae`: cfg.M reps a split (a
    fresh mask_p each), rows dp-sharded, the same artifacts written by
    rank 0. `params=None` loads the trained checkpoint on every rank.
    Returns {stage: {loss, negl, negl_imp, rmse}}."""
    model = get_model(cfg)
    device = mesh.device
    if params is None:
        params = load_trained(dataset, cfg, experiments_root, device=device)
    num_samples = cfg.valid_k if model.eval_kind == "miwae" else None
    results = {}
    for split in (dataset.train, dataset.test):
        if split is None:
            continue
        src = GeneratorNoise(cfg.seed + 1, device) if noise is None else noise
        agg = eval_split_sharded(params, split.x, split.mask, cfg, mesh,
                                 noise=src, num_samples=num_samples,
                                 n_reps=cfg.M)
        results[split.stage] = agg
        if save and multihost.is_coordinator():
            _save_eval_artifacts(cfg, model, split.stage, agg,
                                 experiments_root)
    return results

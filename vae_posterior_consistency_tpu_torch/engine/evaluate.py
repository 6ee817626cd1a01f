"""MCAR and MNAR evaluation (port of the JAX package's `engine/evaluate.py`:
`eval_vae` with `_pad_batches` and `_save_eval_artifacts`, `eval_vae_mnar`
with its one-rep function, and the ensemble evaluators `eval_vae_ensemble`
and `eval_vae_mnar_ensemble`).

Reference behaviour (src/experiment_main/evaluate.py:136-297), as the JAX
package has it: both splits, train then test, each over cfg.M Monte-Carlo
reps. A rep shuffles the split once, wrap-pads the permutation to whole
batches of min(batch_size, n) rows and runs `eval_step` on each batch. A
batch gives its imputation RMSE on the missing cells of its valid rows,
sqrt(se / max(#holes, 1)), and the row-weighted means of the loss, negl and
negl_imp over its valid rows; padded rows weigh 0. The metrics are the mean
over the batches of a rep, then the mean over the reps, in that order.

The JAX package fuses this into one program; here the batches run one by
one, eagerly, with every statistic kept on the device and read once a
split. The sharded evaluator comes with the multi-device slice. Under a
torch profiler a call records the spans `eval_vae` (its root),
`eval.split`, `eval.batch`, `eval.draw`, `model.eval_step`, `eval.stats`
and `eval.readback`, and one `host_reads` a split (`utils/tracing`).

It serves every family. Those whose `eval_kind` is 'miwae' (MIWAE and
notMIWAE) evaluate with cfg.valid_k importance samples a row and save only
the rmse artifact (`artifacts.eval_miwae_paths`); every family's four
metrics go to metrics.jsonl. All noise comes from one source, called as
`noise(kind, rep, step, shape)`:
  "perm"    a permutation of range(shape[0]) (int64), once a rep (step 0);
then, once a batch, the family's draws (`ModelDef.eval_noise`):
  "mask_p"  uniforms [bsz, D] of the batch's fresh `mask_p`, drawn only
            where `eval_step` reads it (regularized MIWAE types), as JAX
            draws it from k_maskp;
  "eps"     standard normals: [bsz, latent_dim] for the gauss
            reparameterisation noise or the flow's base noise, drawn by
            JAX as normal(k_model, ...); [bsz, K, latent_dim] for the
            notMIWAE q branch and a vanilla MIWAE type, and [2, bsz, K,
            latent_dim] for a regularized MIWAE type's q and p branches,
            K = cfg.valid_k, drawn by JAX from split(k_model).
The JAX package draws a fresh `mask_p` for every batch of every family;
where `eval_step` does not read it nothing is drawn for it here. The
default source is `train.GeneratorNoise(cfg.seed + 1, device)`, made anew
for each split, as the JAX package derives both splits' keys from the same
PRNGKey(seed + 1). A given source serves both splits as it is: a stateless
one (for instance one that replays the JAX key stream) then gives both the
same draws.

MNAR (reference: src/experiment_main/evaluate.py:13-69), as the JAX package
has it: cfg.M reps, each one `eval_step` over the whole matrix (K =
cfg.valid_k importance samples a row for the 'miwae' families), its RMSE
sqrt(se / #holes) over all the holes, unclamped; the mean over the reps.
Its noise comes from a source called as `noise(kind, rep, 0, shape)` for
the family's `eval_noise(cfg, N, D)` draws, "mask_p" only where the family
lists it, as in `eval_vae`; the default is `train.GeneratorNoise(cfg.seed +
2, device)`, as the JAX package keys it PRNGKey(seed + 2).

Ensembles (evaluate.py:214-310, 375-414): the stacked parameters of an [S]
ensemble (`parallel/sweep`) evaluate as `eval_step` under `torch.func.vmap`
over the replicas, with the serial evaluator's noise shared by every
replica, as S serial runs of one config would draw it (the same default
sources, `GeneratorNoise(seed + 1)` and `GeneratorNoise(seed + 2)`); only
the parameters, and for `eval_vae_ensemble` each replica's own tables,
differ. Where the JAX package divides its row budget by S
(evaluate.py:297), the port cuts the replica axis into chunks of at most
`ENS_EVAL_ROW_BUDGET` decoder rows (batch rows times importance samples)
a call: a MIWAE-family replica at valid_k 5000 holds about 1 GiB on the
card at its peak, so 128 replicas in one call would not fit. The chunking
moves no value: each replica's arithmetic is the same in any chunk.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.data.loaders import Dataset, Split
from vae_posterior_consistency_tpu_torch.engine import artifacts, checkpoint
from vae_posterior_consistency_tpu_torch.engine.train import (
    GeneratorNoise,
    check_device,
    load_trained,
)
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.ops import masks
from vae_posterior_consistency_tpu_torch.utils import tracing

#: the metrics of one split, in the order the per-batch statistics stack
METRICS = ("rmse", "loss", "negl", "negl_imp")

#: decoder rows (batch rows x importance samples) one vmapped ensemble
#: evaluation call takes at most; the replica axis is cut to fit (about
#: 6 GiB at the MIWAE families' peak on the card)
ENS_EVAL_ROW_BUDGET = 1 << 21


def _pad_batches(n: int, bsz: int):
    steps = math.ceil(n / bsz)
    return steps, steps * bsz - n


def _draw(model, cfg: RunConfig, noise, rep: int, step: int, x, mask):
    """A batch's draws, `ModelDef.eval_noise`: (mask_p or None, eps)."""
    with tracing.span("eval.draw"):
        drawn = {kind: noise(kind, rep, step, shape).to(x.device)
                 for kind, shape in model.eval_noise(cfg, *x.shape).items()}
        mask_p = (masks.sub_mask(mask, cfg.p_missingness,
                                 uniforms=drawn["mask_p"])
                  if "mask_p" in drawn else None)
    return mask_p, drawn["eps"]


def _batch_stats(model, cfg: RunConfig, params, x_b, m_b, mask_p, eps, w_b):
    """One batch's [rmse, loss, negl, negl_imp] (a [4] tensor), padded rows
    weighing 0 (`w_b`)."""
    with tracing.span("model.eval_step"):
        out = model.eval_step(params, x_b, m_b, mask_p, eps, cfg)
    with tracing.span("eval.stats"):
        hole = (1.0 - m_b) * w_b[:, None]
        se = torch.sum(torch.square((out["x_imputed"] - x_b) * hole))
        cnt = torch.sum(w_b)
        return torch.stack([
            torch.sqrt(se / torch.clamp(torch.sum(hole), min=1.0)),
            torch.sum(out["row_loss"] * w_b) / cnt,
            torch.sum(out["row_negl"] * w_b) / cnt,
            torch.sum(out["row_negl_imp"] * w_b) / cnt,
        ])


def _split_metrics(model, cfg: RunConfig, params, x, mask, noise) -> dict:
    """One split over cfg.M reps -> {metric: float}; one host sync."""
    device = x.device
    n = x.shape[0]
    bsz = min(cfg.batch_size, n)
    steps, pad = _pad_batches(n, bsz)
    valid = (torch.arange(steps * bsz, device=device) < n).to(torch.float32)
    per_batch = []
    for m in range(cfg.M):
        perm = noise("perm", m, 0, (n,)).to(device)
        if pad:
            perm = torch.cat([perm, perm[:pad]])
        x_rep, m_rep = x[perm], mask[perm]
        for s in range(steps):
            with tracing.span("eval.batch", rows=bsz):
                rows = slice(s * bsz, (s + 1) * bsz)
                x_b, m_b, w_b = x_rep[rows], m_rep[rows], valid[rows]
                mask_p, eps = _draw(model, cfg, noise, m, s, x_b, m_b)
                per_batch.append(_batch_stats(model, cfg, params, x_b, m_b,
                                              mask_p, eps, w_b))
    with tracing.span("eval.readback"):
        stats = torch.stack(per_batch).reshape(cfg.M, steps, len(METRICS))
        agg = stats.mean(dim=1).mean(dim=0).tolist()  # the one host sync
        tracing.count("host_reads")
    # in sorted key order, as JAX's tree_map returns the dict: the order of
    # the metrics.jsonl records and of the printed metrics
    return dict(sorted(zip(METRICS, agg)))


def _save_eval_artifacts(cfg: RunConfig, model, stage: str, agg: dict,
                         experiments_root: str) -> None:
    """One split's reference-named artifacts and metrics.jsonl records
    (reference: evaluate.py:247-297; the MIWAE families' rmse only,
    evaluate.py:120-133)."""
    if model.eval_kind == "miwae":
        paths = artifacts.eval_miwae_paths(cfg, stage, experiments_root)
        artifacts.save_tensor(agg["rmse"], paths["rmse"])
    else:
        paths = artifacts.eval_vae_paths(cfg, stage, experiments_root)
        artifacts.save_tensor(agg["rmse"], paths["rmse"])
        artifacts.save_tensor(agg["loss"], paths["elbo"])
        artifacts.save_tensor(agg["negl"], paths["negll"])
        artifacts.save_tensor(agg["negl_imp"], paths["negll_imp"])
    for name, val in agg.items():
        artifacts.log_metric(cfg, name, val, stage, experiments_root)


def eval_vae(dataset: Dataset, cfg: RunConfig, params: Optional[dict] = None,
             experiments_root: str = "experiments", noise=None,
             save: bool = True, device="cuda") -> dict:
    """MCAR evaluation and, with `save`, its artifacts (reference:
    evaluate.py:136-297). `params=None` loads the trained checkpoint
    (`train.load_trained`). Returns {stage: {rmse, loss, negl, negl_imp}}."""
    device = check_device(device)
    model = get_model(cfg)
    if params is None:
        params = load_trained(dataset, cfg, experiments_root, device=device)
    params = checkpoint.on_device(params, device)

    results = {}
    with torch.no_grad(), tracing.span("eval_vae"):
        for split in (dataset.train, dataset.test):
            if split is None:
                continue
            with tracing.span("eval.split"):
                src = (GeneratorNoise(cfg.seed + 1, device) if noise is None
                       else noise)
                agg = _split_metrics(
                    model, cfg, params,
                    split.x.to(device=device, dtype=torch.float32),
                    split.mask.to(device=device, dtype=torch.float32), src)
                results[split.stage] = agg
                if save:
                    _save_eval_artifacts(cfg, model, split.stage, agg,
                                         experiments_root)
    return results


#: the reference's alias: its imputation.py routes the 'MIWAE' vae_types
#: here (src/experiment_main/imputation.py:40-49); `eval_vae` dispatches on
#: the family's eval_kind, so it is the same function.
eval_miwae = eval_vae


def _mnar_rmse(model, cfg: RunConfig, params, x, mask, mask_p, eps):
    """One `eval_step` over the whole matrix and its RMSE over all the
    holes (a 0-d tensor on the device): the one definition of a rep that
    serves `eval_vae_mnar` and `eval_vae_mnar_ensemble`."""
    with tracing.span("model.eval_step"):
        out = model.eval_step(params, x, mask, mask_p, eps, cfg)
    hole = 1.0 - mask
    se = torch.sum(torch.square(out["x_imputed"] * hole - x * hole))
    return torch.sqrt(se / torch.sum(hole))


def _mnar_rep(model, cfg: RunConfig, params, x, mask, noise, rep: int):
    """One MNAR rep: its draws, then `_mnar_rmse`."""
    mask_p, eps = _draw(model, cfg, noise, rep, 0, x, mask)
    return _mnar_rmse(model, cfg, params, x, mask, mask_p, eps)


def eval_vae_mnar(data, mask, cfg: RunConfig, params: Optional[dict] = None,
                  experiments_root: str = "experiments", noise=None,
                  save: bool = True, device="cuda") -> float:
    """MNAR evaluation of the matrix `data` [N, D] under `mask` (reference:
    evaluate.py:13-69): the mean over cfg.M reps of the full-matrix RMSE,
    read from the device once; with `save`, its artifact
    (`artifacts.eval_mnar_paths`) and an "rmse_mnar" metric at stage
    "test". `params=None` loads the trained checkpoint."""
    device = check_device(device)
    model = get_model(cfg)
    x = torch.as_tensor(data).to(device=device, dtype=torch.float32)
    mask = torch.as_tensor(mask).to(device=device, dtype=torch.float32)
    if params is None:
        dataset = Dataset(train=Split(x, mask, "train"), test=None,
                          obs_dim=x.shape[1])
        params = load_trained(dataset, cfg, experiments_root, device=device)
    params = checkpoint.on_device(params, device)
    noise = GeneratorNoise(cfg.seed + 2, device) if noise is None else noise
    with torch.no_grad():
        # one rep at a time, as the JAX package maps over them
        reps = [_mnar_rep(model, cfg, params, x, mask, noise, m)
                for m in range(cfg.M)]
        rmse = torch.stack(reps).mean().item()  # the one host sync
    if save:
        paths = artifacts.eval_mnar_paths(cfg, experiments_root)
        artifacts.save_tensor(rmse, paths["rmse"])
        artifacts.log_metric(cfg, "rmse_mnar", rmse, "test", experiments_root)
    return rmse


# ---------------------------------------------------------------------------
# ensembles
# ---------------------------------------------------------------------------


def _replica_chunk(model, cfg: RunConfig, rows: int) -> int:
    """Replicas a vmapped evaluation call takes: as many as fit
    ENS_EVAL_ROW_BUDGET decoder rows, at least one."""
    per = rows * (cfg.valid_k if model.eval_kind == "miwae" else 1)
    return max(1, ENS_EVAL_ROW_BUDGET // max(per, 1))


def _chunked(fn, params_ens, tensors, S: int, chunk: int):
    """fn(params, *tensors) vmapped over the replicas of `params_ens` and of
    `tensors` (each [S, ...], or None), chunk replicas a call, the results
    concatenated."""
    flat = checkpoint.flatten(params_ens)
    dims = (0, *(None if t is None else 0 for t in tensors))
    out = []
    for lo in range(0, S, chunk):
        p = checkpoint.unflatten({k: v[lo:lo + chunk]
                                  for k, v in flat.items()})
        args = [None if t is None else t[lo:lo + chunk] for t in tensors]
        out.append(torch.func.vmap(fn, in_dims=dims)(p, *args))
    return torch.cat(out)


def _split_metrics_ensemble(model, cfg: RunConfig, params_ens, xs, ms,
                            noise) -> np.ndarray:
    """One split of every replica over cfg.M reps -> [S, len(METRICS)]
    (numpy, sorted as METRICS); the draws shared by the replicas, one host
    sync."""
    S, n, D = xs.shape
    device = xs.device
    bsz = min(cfg.batch_size, n)
    steps, pad = _pad_batches(n, bsz)
    valid = (torch.arange(steps * bsz, device=device) < n).to(torch.float32)
    chunk = _replica_chunk(model, cfg, bsz)
    per_batch = []
    for m in range(cfg.M):
        perm = noise("perm", m, 0, (n,)).to(device)
        if pad:
            perm = torch.cat([perm, perm[:pad]])
        x_rep, m_rep = xs[:, perm], ms[:, perm]
        for s in range(steps):
            rows = slice(s * bsz, (s + 1) * bsz)
            x_b, m_b, w_b = x_rep[:, rows], m_rep[:, rows], valid[rows]
            drawn = {kind: noise(kind, m, s, shape).to(device) for kind, shape
                     in model.eval_noise(cfg, bsz, D).items()}
            mask_p = (m_b * masks.mcar_mask(
                (bsz, D), cfg.p_missingness, uniforms=drawn["mask_p"])
                      if "mask_p" in drawn else None)
            eps = drawn["eps"]

            def stats(p, x_b, m_b, mask_p):
                return _batch_stats(model, cfg, p, x_b, m_b, mask_p, eps,
                                    w_b)

            per_batch.append(_chunked(stats, params_ens, (x_b, m_b, mask_p),
                                      S, chunk))  # [S, 4]
    stats = torch.stack(per_batch).reshape(cfg.M, steps, S, len(METRICS))
    return stats.mean(dim=1).mean(dim=0).cpu().numpy()  # the one host sync


def eval_vae_ensemble(datasets, cfgs, params_ens,
                      experiments_root: str = "experiments", noise=None,
                      save: bool = True, save_rows=None,
                      device="cuda") -> list:
    """Evaluate an [S]-replica ensemble (`parallel/sweep`), replica i on
    datasets[i] under cfgs[i] (evaluate.py:214-310): the serial evaluator's
    metrics and artifacts for each config, its draws shared by every
    replica (`noise` as `eval_vae`'s; by default GeneratorNoise(cfgs[0].seed
    + 1) anew for each split).

    The configs must agree on everything but the vae_type split digit, and
    a split must be present for every dataset or for none, with one row
    count across the group; each refusal is the JAX package's. `save_rows`
    restricts the artifact writes to those replica rows (all when None):
    seed replicas of one config share its artifact paths, so a `-seeds N`
    caller saves the seed-0 rows. Returns [{stage: {metric: float}}]
    aligned with `cfgs`."""
    device = check_device(device)
    S = len(cfgs)

    def _ident(cfg):
        stripped = "".join(c for c in cfg.vae_type if not c.isdigit())
        return dataclasses.astuple(cfg.replace(vae_type=stripped))

    bad = [c.vae_type for c in cfgs if _ident(c) != _ident(cfgs[0])]
    if bad:
        raise ValueError(
            "eval_vae_ensemble needs config-identical replicas (only the "
            f"vae_type split digit may differ); {bad} disagree with "
            f"{cfgs[0].vae_type} — evaluate those through eval_vae instead")
    model = get_model(cfgs[0])
    params_ens = checkpoint.on_device(params_ens, device)
    results = [dict() for _ in range(S)]
    rows = set(range(S) if save_rows is None else save_rows)
    with torch.no_grad():
        for stage in ("train", "test"):
            splits = [getattr(d, stage) for d in datasets]
            if all(s is None for s in splits):
                continue
            if any(s is None for s in splits):
                raise ValueError(
                    f"eval_vae_ensemble: {stage} split present for only "
                    f"{sum(s is not None for s in splits)}/{len(splits)} "
                    "datasets in the group; provide it for all or none")
            n = splits[0].n
            if any(s.n != n for s in splits):
                raise ValueError(
                    f"eval_vae_ensemble needs identical {stage}-split sizes "
                    f"across the group; got {[s.n for s in splits]}")
            xs = torch.stack([s.x.to(device=device, dtype=torch.float32)
                              for s in splits])
            ms = torch.stack([s.mask.to(device=device, dtype=torch.float32)
                              for s in splits])
            src = (GeneratorNoise(cfgs[0].seed + 1, device) if noise is None
                   else noise)
            agg_s = _split_metrics_ensemble(model, cfgs[0], params_ens, xs,
                                            ms, src)
            for i, cfg in enumerate(cfgs):
                agg = dict(sorted(zip(METRICS, map(float, agg_s[i]))))
                results[i][stage] = agg
                if save and i in rows:
                    _save_eval_artifacts(cfg, model, stage, agg,
                                         experiments_root)
    return results


def eval_vae_mnar_ensemble(data, mask, cfg: RunConfig, params_ens,
                           experiments_root: str = "experiments", noise=None,
                           save: bool = True, device="cuda") -> np.ndarray:
    """MNAR evaluation of an [S]-replica seed ensemble (evaluate.py:
    375-414): `eval_vae_mnar`'s reps for every replica, their draws shared
    (`noise` as `eval_vae_mnar`'s; by default GeneratorNoise(cfg.seed +
    2)). With `save`, the seed-0 replica's RMSE goes to the reference
    artifact path and metrics.jsonl. Returns the [S] RMSEs (numpy)."""
    device = check_device(device)
    model = get_model(cfg)
    x = torch.as_tensor(data).to(device=device, dtype=torch.float32)
    mask = torch.as_tensor(mask).to(device=device, dtype=torch.float32)
    params_ens = checkpoint.on_device(params_ens, device)
    S = next(iter(checkpoint.flatten(params_ens).values())).shape[0]
    noise = GeneratorNoise(cfg.seed + 2, device) if noise is None else noise
    chunk = _replica_chunk(model, cfg, x.shape[0])
    with torch.no_grad():
        reps = []
        for m in range(cfg.M):
            # the replicas share the data, the mask and the draws
            mask_p, eps = _draw(model, cfg, noise, m, 0, x, mask)
            reps.append(_chunked(
                lambda p: _mnar_rmse(model, cfg, p, x, mask, mask_p, eps),
                params_ens, (), S, chunk))
        rmses = torch.stack(reps).mean(dim=0).cpu().numpy()
    if save:
        paths = artifacts.eval_mnar_paths(cfg, experiments_root)
        artifacts.save_tensor(float(rmses[0]), paths["rmse"])
        artifacts.log_metric(cfg, "rmse_mnar", float(rmses[0]), "test",
                             experiments_root)
    return rmses

"""Sweep parallelism: whole training runs over seeds, splits, alphas and
missing rates trained as one ensemble (port of the JAX package's
`parallel/sweep.py`).

The reference runs its (3 data splits) x (alpha) x (missing-rate) sweep as
serial Python loops (reference: src/experiment_main/imputation.py:21-25).
Here one axis of the sweep trains at once. As in the JAX package
(sweep.py:9-23), the ensemble's parameters are a stacked dict: every leaf
has a leading [S] replica axis. A step is `torch.func.vmap` of the model's
`train_loss` over the replicas (the port's losses take their parameters and
noise as arguments, so no `functional_call` is needed), one `backward()` of
the summed losses, and one `torch.optim.Adam(1e-3)` over the stacked leaves,
which is elementwise and so the same as S separate updates, as optax's is.
On CUDA tensors the fused kernels run once a step for all replicas: their
vmap rules fold the replica axis into the kernels' own (ops/fused_posterior,
ops/fused_embed_pool).

Noise (sweep.py:25-33, 151-190). An ensemble noise source is called once an
epoch as `noise.epoch(epoch, n, steps, shapes)`, `epoch` 0-based and
absolute (a resumed ensemble draws what the uninterrupted one drew), `n`
the training rows, `shapes` {kind: shape of one replica's draw in one step}
in the order a step draws them (the mask kind, "mask_p" or "drop", then the
family's `ModelDef.train_noise`); a seed ensemble's source also answers
`group(lo, hi)` with the source of replicas lo..hi-1 (for groups past
SEED_GROUP_MAX_S). `epoch` returns {"perm": ..., kind: ...}, the draws of
the mode's sharing rule:
  seed mode   every replica its own permutation and streams: "perm" [S, n],
              each kind [steps, S, *shape];
  split mode  one permutation shared by the replicas (they hold different
              tables), their own mask and model streams: "perm" [n], each
              kind [steps, S, *shape];
  alpha mode  everything shared: "perm" [n], each kind [steps, *shape]; with
              swept missing rates the one draw of uniforms is cut at each
              replica's own threshold.
`EnsembleNoise` is the default: in seed mode one `torch.Generator` a
replica, seeded from its seed value and the epoch (`train.epoch_seed(seed +
1, epoch)`), so a replica's draws do not depend on the other replicas and
a group split leaves them as they are; in the other modes one generator
seeded from (cfg.seed + 13 or + 7, the JAX package's tags, and the epoch).
Each draws a whole epoch at once. The validation objective's draws are made
once, shared by the replicas, from a serial noise source (`val_noise`,
`train.GeneratorNoise(cfg.seed, device)` by default) at epoch
`train.VAL_EPOCH`, and the loss is taken at the fixed epoch cfg.epoch
(sweep.py:243-284).

Rows. Every step gathers its rows by index from the training table (the
JAX package's per-step gather layout, sweep.py:102-114; its epoch-table
layout, a TPU layout choice that gives the same values, is not ported):
[S, bsz] indices into the [n, D] table in seed mode, [bsz] into the [S, n, D]
tables in split mode and into the shared table in alpha mode.

Mesh (sweep.py:385-416, the trainers' `mesh`). With a (dp, tp) mesh the
replica axis is dp-sharded with no collective inside a step: the S rows
are padded to S_run, a multiple of dp, as the JAX package pads them (the
last seed, alpha or sweep row repeated; the last split duplicated, with
init seeds `epoch_seed(cfg.seed, i)` for i < S_run), each dp rank
(`parallel/mesh.Rows`; the tp ranks of one dp index repeat its work) runs
the chunk above on its S_run/dp replicas, and its noise is the global
S_run source's draws cut to its rows (`parallel/mesh.RankRows`: the
replica axis of each kind, and of the seed mode's permutations; the alpha
mode's shared draws stay whole). `shard_ensemble` lays a stacked state out
so. The early-stopping tracker sees all S_run rows, padding included: the
per-replica validation losses and parameters are all-gathered at each
check, so every rank makes the same decision. Rank 0 writes the resume
file from the gathered S_run rows, and a resumed rank takes its rows of
it (`_shard_fn`). The trainers return the gathered first S rows on every
rank.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.engine import checkpoint
from vae_posterior_consistency_tpu_torch.engine.train import (
    VAL_EPOCH,
    GeneratorNoise,
    check_device,
    draw,
    epoch_seed,
    make_optimizer,
    trainable,
)
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.ops import masks as masks_ops
from vae_posterior_consistency_tpu_torch.parallel import mesh as meshlib
from vae_posterior_consistency_tpu_torch.parallel import multihost

#: widest seed ensemble trained as one group (sweep.py:57-70):
#: train_seed_ensemble trains wider requests as groups of at most this many
#: replicas, one after the other. Every replica's draws are keyed by its
#: seed value, so grouping changes no draw.
SEED_GROUP_MAX_S = 512

#: the JAX package's stream tags of the split and alpha modes (sweep.py:170)
_MODE_TAG = {"split": 13, "alpha": 7}


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------


class EnsembleNoise:
    """The default ensemble noise source (see the module docstring):
    `mode` 'seed' with the replicas' `seeds`, or 'split' / 'alpha' with
    `S` replicas under `seed`."""

    def __init__(self, mode: str, device, seeds=None, seed: int = 0,
                 S: Optional[int] = None):
        self.mode = mode
        self.device = torch.device(device)
        self.seeds = None if seeds is None else [int(s) for s in seeds]
        self.S = len(self.seeds) if seeds is not None else S
        self.seed = seed
        self.generator = torch.Generator(device=self.device)

    def epoch(self, epoch: int, n: int, steps: int, shapes: dict) -> dict:
        g, dev = self.generator, self.device
        if self.mode == "seed":
            per = []
            for s in self.seeds:
                g.manual_seed(epoch_seed(s + 1, epoch))
                per.append([draw(g, "perm", (n,), dev)]
                           + [draw(g, kind, (steps, *shape), dev)
                              for kind, shape in shapes.items()])
            out = {"perm": torch.stack([p[0] for p in per])}
            for j, kind in enumerate(shapes, start=1):
                out[kind] = torch.stack([p[j] for p in per], dim=1)
            return out
        g.manual_seed(epoch_seed(self.seed + _MODE_TAG[self.mode], epoch))
        out = {"perm": draw(g, "perm", (n,), dev)}
        lead = (steps, self.S) if self.mode == "split" else (steps,)
        for kind, shape in shapes.items():
            out[kind] = draw(g, kind, (*lead, *shape), dev)
        return out

    def group(self, lo: int, hi: int) -> "EnsembleNoise":
        """The source of replicas lo..hi-1 of a seed ensemble (its groups
        draw what the whole ensemble draws for them)."""
        return EnsembleNoise("seed", self.device, seeds=self.seeds[lo:hi])


def _keep_thresholds(missings, device) -> torch.Tensor:
    """[S, 1, 1] float32: each replica's MCAR keep threshold 1 - rate/100,
    rounded as the serial path rounds it (ops/masks._keep_threshold)."""
    return torch.tensor([masks_ops._keep_threshold(m) for m in missings],
                        dtype=torch.float32, device=device)[:, None, None]


def _masks(cfg: RunConfig, mask, uniforms, keep):
    """(eff_mask, mask_p) of a batch: ops/masks.train_masks, with `mask` and
    `uniforms` each with or without a replica axis (the drop mask's
    uniforms come [..., 2, B, D]). A regularized type's mask_p cuts the
    uniforms at cfg.p_missingness's keep threshold, or with `keep` ([S, 1,
    1] thresholds of swept missing rates) at each replica's own."""
    info = cfg.info
    if info.regularized:
        thr = masks_ops._keep_threshold(cfg.p_missingness) if keep is None \
            else keep
        return mask, mask * (uniforms < thr).to(torch.float32)
    if info.with_drop:
        u = uniforms.movedim(-3, 0)
        eff = mask * masks_ops.eddi_drop_mask(tuple(u.shape[1:]), uniforms=u)
        return eff, torch.ones_like(eff)
    return mask, torch.ones_like(mask)


def _replica_dim(t, base: int):
    """vmap's in_dim of `t`: 0 when it carries a replica axis in front of
    its `base` axes, None when the replicas share it."""
    return 0 if t.dim() > base else None


def _mask_kind(cfg: RunConfig):
    info = cfg.info
    return "mask_p" if info.regularized else "drop" if info.with_drop else None


def _noise_shapes(cfg: RunConfig, model, B: int, D: int) -> dict:
    """{kind: shape} of one replica's draws in one step, in draw order."""
    kind = _mask_kind(cfg)
    shapes = {} if kind is None else {
        kind: (B, D) if kind == "mask_p" else (2, B, D)}
    shapes.update(model.train_noise(cfg, B, D))
    return shapes


# ---------------------------------------------------------------------------
# the ensemble step and its runner
# ---------------------------------------------------------------------------


def _stacked_init(model, cfg: RunConfig, obs_dim: int, init_seeds, device):
    """Stacked ensemble init: replica i from `model.init` under a generator
    seeded with init_seeds[i]; every leaf gains a leading [S] axis."""
    reps = [checkpoint.flatten(model.init(
        torch.Generator(device=device).manual_seed(int(s)), cfg, obs_dim,
        device=device)) for s in init_seeds]
    return checkpoint.unflatten({k: torch.stack([r[k] for r in reps])
                                 for k in reps[0]})


def _make_ensemble_chunk(cfg: RunConfig, model, data, mask, *, mode: str,
                         S: int, noise, alphas=None, missings=None):
    """The ensemble chunk runner.

    data/mask: [S, n, D] stacked per-replica tables when mode == 'split',
    else one shared [n, D] table. `alphas` and `missings`: optional [S]
    per-replica alpha and p_missingness; alpha enters the loss through
    cfg.replace (sweep.py:116-118), the rate only the mask_p threshold
    (sweep.py:135-140). Returns run_chunk(params, optimizer, epoch0,
    n_epochs) -> history [n_epochs, S] (float32 numpy, each epoch the sum
    of its steps' losses), `params` updated in place by `optimizer`; the
    history is read from the device once a chunk."""
    per_replica_data = mode == "split"
    n = data.shape[1] if per_replica_data else data.shape[0]
    obs_dim = data.shape[-1]
    device = data.device
    bsz = min(cfg.batch_size, n)
    steps = math.ceil(n / bsz)
    pad = steps * bsz - n
    alpha_v = (None if alphas is None else
               torch.as_tensor(alphas, dtype=torch.float32, device=device))
    keep = None if missings is None else _keep_thresholds(missings, device)
    shapes = _noise_shapes(cfg, model, bsz, obs_dim)
    mask_kind = _mask_kind(cfg)
    # vmap axes: the rows and the streams are each replica's own unless the
    # alpha mode shares them; a mask is a replica's own when it has a
    # replica axis (its rows or its uniforms do, or its rate is swept)
    ax = None if mode == "alpha" else 0
    alpha_ax = None if alpha_v is None else 0

    def replica_loss(p, x_b, m_b, mp_b, eps, extra, epoch, alpha):
        c = cfg.replace(alpha=alpha) if alpha is not None else cfg
        return model.train_loss(p, x_b, m_b, mp_b, eps, epoch, c,
                                **extra)[0]

    def run_chunk(params, optimizer, epoch0: int, n_epochs: int):
        totals = []
        for off in range(n_epochs):
            e = epoch0 + off
            epoch = float(e + 1)
            drawn = dict(noise.epoch(e, n, steps, shapes))
            perm = drawn.pop("perm").to(device)
            if pad:
                perm = torch.cat([perm, perm[..., :pad]], dim=-1)
            total = torch.zeros(S, device=device)
            for s in range(steps):
                idx = perm[..., s * bsz:(s + 1) * bsz]
                if per_replica_data:
                    x_b, m_b = data[:, idx], mask[:, idx]
                else:
                    x_b, m_b = data[idx], mask[idx]
                step = {k: v[s].to(device) for k, v in drawn.items()}
                uniforms = step.pop(mask_kind) if mask_kind else None
                eff, mask_p = _masks(cfg, m_b, uniforms, keep)
                eps = step.pop("eps")
                loss_fn = torch.func.vmap(
                    lambda p, x_b, m_b, mp_b, eps, extra, a: replica_loss(
                        p, x_b, m_b, mp_b, eps, extra, epoch, a),
                    in_dims=(0, ax, _replica_dim(eff, 2),
                             _replica_dim(mask_p, 2), ax, ax, alpha_ax))
                optimizer.zero_grad(set_to_none=True)
                per = loss_fn(params, x_b, eff, mask_p, eps, step, alpha_v)
                per.sum().backward()
                optimizer.step()
                total += per.detach()
            totals.append(total)
        return torch.stack(totals).cpu().numpy()  # the chunk's one sync

    return run_chunk


def _make_ensemble_val_fn(cfg: RunConfig, model, val_x, val_m, val_noise, *,
                          per_replica_data=False, alphas=None, missings=None):
    """The stacked validation objective of per-replica early stopping:
    val_fn(params_ens) -> [S] losses (numpy), the vmapped `train` validation
    (engine/train._build_val_fn) with its two pins: the draws are made once
    (a step's at epoch VAL_EPOCH, from `val_noise`) and shared by every
    replica whatever the training streams, and the loss is taken at the
    fixed epoch cfg.epoch (sweep.py:243-284). Each replica's alpha and
    p_missingness still enter its own objective."""
    vn, D = val_x.shape[-2:]
    device = val_x.device
    alpha_v = (None if alphas is None else
               torch.as_tensor(alphas, dtype=torch.float32, device=device))
    keep = None if missings is None else _keep_thresholds(missings, device)
    kind = _mask_kind(cfg)
    shapes = _noise_shapes(cfg, model, vn, D)
    drawn = {k: val_noise(k, VAL_EPOCH, 0, shape).to(device)
             for k, shape in shapes.items()}
    uniforms = drawn.pop(kind) if kind else None
    eff, mask_p = _masks(cfg, val_m, uniforms, keep)
    eps = drawn.pop("eps")
    data_ax = 0 if per_replica_data else None
    fixed_epoch = float(cfg.epoch)

    def row_loss(p, x, m, mp, a):
        c = cfg.replace(alpha=a) if a is not None else cfg
        return model.train_loss(p, x, m, mp, eps, fixed_epoch, c,
                                **drawn)[0]

    loss_fn = torch.func.vmap(row_loss, in_dims=(
        0, data_ax, _replica_dim(eff, 2), _replica_dim(mask_p, 2),
        None if alpha_v is None else 0))

    def val_fn(params_ens):
        with torch.no_grad():
            return loss_fn(params_ens, val_x, eff, mask_p,
                           alpha_v).cpu().numpy()

    return val_fn


def _val_split(dataset):
    """Validation split of early stopping: test when present, else train,
    as the serial engine has it (ROADMAP C.6.1 logs the JAX package's
    choice, ported as it is)."""
    return dataset.test if dataset.test is not None else dataset.train


def _run_chunked(run_chunk, params, epochs: int, chunk_epochs: int,
                 resume_path=None, checkpoint_every=None, resume=False,
                 resume_tag="", val_fn=None, early_stopping=None, rows=None):
    """Drive an ensemble chunk runner to `epochs` with the serial engine's
    restart contract (sweep.py:293-382): with `checkpoint_every=N` the
    stacked (parameters, Adam state, epochs done) go to `resume_path`
    every N epochs and at the end (`checkpoint.save_resume`, one file for
    the whole ensemble, tagged `resume_tag`); `resume=True` continues from
    it. With `val_fn` and `early_stopping` (`EnsembleEarlyStopping`) a
    per-replica check runs at every multiple of chunk_epochs and at the
    end, whatever checkpoint_every is, and the ensemble stops once every
    replica has used up its patience; each replica's best-check parameters
    are returned (host tensors once a check ran). As in the JAX package,
    `early_stopping` is read without a None guard when `val_fn` is given
    (ROADMAP C.6.3).

    `rows` (`parallel/mesh.Rows`) places this rank's replicas in the
    padded ensemble of a mesh: the resume file holds all of them (written
    by rank 0 from the gathered state, each rank taking its rows back,
    `_shard_fn`), the tracker sees all of them (the losses and parameters
    all-gathered at each check), and the returned parameters and history
    [S_run, epochs run here] are all of them, on every rank."""
    if (checkpoint_every or resume) and not resume_path:
        raise ValueError(
            "checkpoint_every/resume require resume_path on the ensemble "
            "trainers (the CLI derives it; API callers must pass one)")
    if rows is None:
        S = next(iter(checkpoint.flatten(params).values())).shape[0]
        rows = meshlib.Rows(S, S, 1, 0)
    on_mesh = rows.group is not None
    device = next(iter(checkpoint.flatten(params).values())).device
    done, opt_state = 0, None
    if resume and os.path.exists(resume_path):
        template = checkpoint.unflatten({
            k: v.new_empty((rows.padded, *v.shape[1:]))
            for k, v in checkpoint.flatten(params).items()})
        params, opt_state, done = checkpoint.load_resume(
            template, resume_path, tag=resume_tag, max_epochs=epochs)
        params, opt_state = _shard_fn(rows)(params, opt_state)
    params = trainable(params)
    optimizer = make_optimizer(params)
    if opt_state is not None:
        checkpoint.load_adam_state(optimizer, params, opt_state)
    history = []
    while done < epochs:
        n_e = min(chunk_epochs, epochs - done)
        if checkpoint_every:
            n_e = min(n_e, checkpoint_every - done % checkpoint_every)
        if val_fn is not None:
            n_e = min(n_e, chunk_epochs - done % chunk_epochs)
        history.append(run_chunk(params, optimizer, done, n_e))
        done += n_e
        if checkpoint_every and (done % checkpoint_every == 0
                                 or done >= epochs):
            # the final boundary is always written, so a later run with a
            # larger budget resumes instead of retraining
            state = checkpoint.adam_state(optimizer, params)
            full = rows.gather_tree(params, cut=False)
            state = checkpoint.AdamState(
                state.count, rows.gather_tree(state.mu, cut=False),
                rows.gather_tree(state.nu, cut=False))
            if multihost.is_coordinator():
                checkpoint.save_resume(full, state, done, resume_path,
                                       tag=resume_tag)
            if on_mesh:
                multihost.barrier(device)
        if val_fn is not None and (done % chunk_epochs == 0
                                   or done >= epochs):
            losses = rows.gather(torch.as_tensor(val_fn(params),
                                                 device=device), cut=False)
            if early_stopping.update(losses.cpu().numpy(),
                                     rows.gather_tree(params, cut=False)):
                break
    params = rows.gather_tree(params, cut=False)
    if early_stopping is not None and early_stopping.best_params is not None:
        params = early_stopping.best_params
    if not history:
        return params, np.zeros((rows.padded, 0), np.float32)
    hist = torch.from_numpy(np.concatenate(history, axis=0).T.copy())
    return params, rows.gather(hist.to(device), cut=False).cpu().numpy()


def shard_ensemble(params_ens, opt_state, mesh):
    """This rank's replica rows of an ensemble's stacked state over the
    mesh's dp axis (sweep.py:385-408): every leaf of `params_ens` and of
    the moments of `opt_state` (a `checkpoint.AdamState`, or None) cut to
    the rank's rows. Replicas never communicate, so a step needs no
    collective. Requires S % dp == 0."""
    dp = mesh.shape["dp"]
    S = next(iter(checkpoint.flatten(params_ens).values())).shape[0]
    if S % dp != 0:
        raise ValueError(f"ensemble size {S} not divisible by dp={dp}")
    return _shard_fn(meshlib.rows_of(mesh, S))(params_ens, opt_state)


def _shard_fn(rows):
    """The resume re-shard of `_run_chunked`: (params, opt_state) of the
    whole padded ensemble, as a resume file holds them -> this rank's
    rows."""
    def shard(params, opt_state):
        if opt_state is not None:
            opt_state = checkpoint.AdamState(
                opt_state.count, rows.take_tree(opt_state.mu),
                rows.take_tree(opt_state.nu))
        return rows.take_tree(params), opt_state

    return shard


def _ensemble_rows(mesh, S: int, device):
    """(rows, device) of an S-replica ensemble: this rank's `Rows` of the
    replica axis, padded to a multiple of dp on a mesh, and the device the
    replicas train on (the mesh's, else `device`)."""
    if mesh is None:
        return meshlib.Rows(S, S, 1, 0), check_device(device)
    return meshlib.rows_of(mesh, S), mesh.device


def _padded(values, rows) -> list:
    """`values` (one a replica) padded to rows.padded by repeating the
    last, as the JAX package pads its seeds, alphas and sweep rows."""
    values = list(values)
    return values + [values[-1]] * (rows.padded - len(values))


def _rank_noise(noise, rows, mode: str, cfg: RunConfig, model):
    """The ensemble noise source of this rank's replicas: `noise` (drawing
    for all rows.padded replicas) cut to its rows along the replica axis
    of each step kind and, in seed mode, of the permutations; the alpha
    mode's draws are shared and pass whole."""
    if rows.dp == 1 or mode == "alpha":
        return noise
    axes = {kind: 1 for kind in _noise_shapes(cfg, model, 1, 1)}
    axes["perm"] = 0 if mode == "seed" else None
    return meshlib.RankRows(noise, axes, rows.dp, rows.r)


def _local_params(params, rows, device):
    """A caller's stacked `params` (rows.padded replicas) -> this rank's
    rows on `device`."""
    params = checkpoint.on_device(params, device)
    S = next(iter(checkpoint.flatten(params).values())).shape[0]
    if S != rows.padded:
        raise ValueError(f"params hold {S} replicas; this ensemble runs "
                         f"{rows.padded} (padded to a multiple of dp)")
    return rows.take_tree(params)


def _take_rows(params_ens, S: int):
    """The first S replica rows of a stacked ensemble."""
    return ensemble_replica(params_ens, slice(0, S))


def ensemble_replica(params, i):
    """Replica i's parameters of a stacked ensemble; with a slice or a list
    of rows for `i`, those replicas, still stacked."""
    return checkpoint.unflatten({k: v[i] for k, v
                                 in checkpoint.flatten(params).items()})


def _table(split, device):
    return (split.x.to(device=device, dtype=torch.float32),
            split.mask.to(device=device, dtype=torch.float32))


def _shared_table_val_fn(dataset, cfg, model, device, val_noise,
                          alphas=None, missings=None):
    vx, vm = _table(_val_split(dataset), device)
    return _make_ensemble_val_fn(
        cfg, model, vx, vm,
        GeneratorNoise(cfg.seed, device) if val_noise is None else val_noise,
        alphas=alphas, missings=missings)


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------


def build_seed_ensemble_runner(dataset, cfg: RunConfig, seeds, device="cuda",
                               noise=None, params=None, mesh=None):
    """The len(seeds)-replica chunk runner and its stacked parameters:
    (run_chunk, params_ens). run_chunk(params, optimizer, epoch0, n_epochs)
    -> losses [n_epochs, S]; `params` must be trainable leaves
    (`train.trainable(params_ens)`) and `optimizer` Adam over them
    (`train.make_optimizer`). Replica i starts from `model.init` seeded
    with seeds[i] (the serial `train`'s init of a run with that seed) unless
    `params` (stacked) is given; `noise` defaults to
    EnsembleNoise('seed', seeds=seeds). With `mesh`, the seeds are padded
    to a multiple of dp by repeating the last (sweep.py:436-441) and the
    runner and parameters are this rank's rows of them (`params`, when
    given, holds all the padded rows)."""
    model = get_model(cfg)
    rows, device = _ensemble_rows(mesh, len(seeds), device)
    seeds = _padded([int(s) for s in seeds], rows)
    params_ens = (_stacked_init(model, cfg, dataset.obs_dim,
                                seeds[rows.lo:rows.hi], device)
                  if params is None else _local_params(params, rows, device))
    x, m = _table(dataset.train, device)
    run_chunk = _make_ensemble_chunk(
        cfg, model, x, m, mode="seed", S=rows.local,
        noise=_rank_noise(EnsembleNoise("seed", device, seeds=seeds)
                          if noise is None else noise, rows, "seed", cfg,
                          model))
    return run_chunk, params_ens


def train_seed_ensemble(dataset, cfg: RunConfig, seeds,
                        chunk_epochs: int = 200, checkpoint_every=None,
                        resume=False, resume_path=None,
                        early_stopping=None, device="cuda", noise=None,
                        params=None, val_noise=None, mesh=None):
    """Train len(seeds) independent replicas of one config as one ensemble
    (sweep.py:455-524). Returns (stacked params [S, ...], loss history
    [S, epochs run]). Each replica has its own init and its own shuffle,
    mask and model streams. With `mesh`, the replicas are dp-sharded (see
    the module docstring); `noise` then draws for the padded seeds.

    Requests wider than SEED_GROUP_MAX_S train as groups of at most that
    many replicas, one after the other; with checkpoint_every/resume,
    group i writes `resume_path + '.g{i}'`, and the groups' histories are
    padded on the left with NaN to the longest. Each group gets a fresh
    tracker (`early_stopping.clone_config()`), so the caller's tracker keeps
    no state (ROADMAP C.6.2). `early_stopping` checks each replica at every
    chunk_epochs boundary against the test split (train when absent) and
    returns each replica's best-check parameters."""
    seeds = list(seeds)
    S = len(seeds)
    if S > SEED_GROUP_MAX_S:
        g = SEED_GROUP_MAX_S
        parts = [train_seed_ensemble(
            dataset, cfg, seeds[i:i + g], chunk_epochs=chunk_epochs,
            checkpoint_every=checkpoint_every, resume=resume,
            resume_path=(f"{resume_path}.g{i // g}" if resume_path
                         else None),
            early_stopping=(early_stopping.clone_config()
                            if early_stopping is not None else None),
            device=device,
            noise=None if noise is None else noise.group(i, i + g),
            params=(None if params is None
                    else ensemble_replica(params, slice(i, i + g))),
            val_noise=val_noise, mesh=mesh)
            for i in range(0, S, g)]
        flat = [checkpoint.flatten(p) for p, _ in parts]
        params_out = checkpoint.unflatten({
            k: torch.cat([f[k].to(flat[0][k].device) for f in flat])
            for k in flat[0]})
        hists = [np.asarray(h) for _, h in parts]
        L = max(h.shape[1] for h in hists)
        hists = [np.pad(h, ((0, 0), (L - h.shape[1], 0)),
                        constant_values=np.nan) if h.shape[1] < L else h
                 for h in hists]
        return params_out, np.concatenate(hists, axis=0)
    run_chunk, params_ens = build_seed_ensemble_runner(
        dataset, cfg, seeds, device=device, noise=noise, params=params,
        mesh=mesh)
    rows, device = _ensemble_rows(mesh, S, device)
    val_fn = None
    if early_stopping is not None:
        val_fn = _shared_table_val_fn(dataset, cfg, get_model(cfg), device,
                                       val_noise)
    params_ens, hist = _run_chunked(
        run_chunk, params_ens, cfg.epoch, chunk_epochs,
        resume_path=resume_path, checkpoint_every=checkpoint_every,
        resume=resume,
        resume_tag=("seed:" + ",".join(str(s) for s in seeds)
                    + f":batch={cfg.batch_size}"),
        val_fn=val_fn, early_stopping=early_stopping, rows=rows)
    return _take_rows(params_ens, S), hist[:S]


def train_split_ensemble(datasets, cfg: RunConfig, chunk_epochs: int = 200,
                         n_seeds: int = 1, checkpoint_every=None,
                         resume=False, resume_path=None, early_stopping=None,
                         device="cuda", noise=None, params=None,
                         val_noise=None, mesh=None):
    """Train one replica per data split of one model family as one ensemble
    (the reference's `vae_type` digit axis; sweep.py:527-632). Each replica
    has its own (x, mask) tables, its own init (a generator seeded with
    `train.epoch_seed(cfg.seed, i)` for replica i) and its own mask and
    model streams; the shuffle order is shared. Returns (params [S, ...],
    loss history [S, epochs]).

    `n_seeds > 1` repeats the split axis: row s * n_splits + i holds seed s
    of split i, each row its own init and streams. A mixed obs_dim is
    refused. Ragged splits wrap-pad to the group's largest row count (row
    j of a padded table is the split's row j mod n_i), so every replica
    takes the same number of steps an epoch; an equal-size group is
    unchanged. Early stopping validates each replica on its own split's
    test table (train where absent), wrap-padded the same way. With
    `mesh`, the replicas are padded to a multiple of dp by duplicating the
    last split (sweep.py:579-602) and dp-sharded; `noise` then draws for
    the padded replicas."""
    model = get_model(cfg)
    if n_seeds > 1:
        datasets = list(datasets) * n_seeds
    S = len(datasets)
    obs_dims = {d.train.x.shape[1] for d in datasets}
    if len(obs_dims) > 1:
        raise ValueError(
            "train_split_ensemble needs one obs_dim across the group; got "
            f"{sorted(obs_dims)} — these are different tables, not splits")
    rows, device = _ensemble_rows(mesh, S, device)
    run_sets = _padded(datasets, rows)
    local = run_sets[rows.lo:rows.hi]

    def stack(tables, n_max):
        return torch.stack([
            t if t.shape[0] == n_max else
            t[torch.arange(n_max, device=t.device) % t.shape[0]]
            for t in tables])

    n_max = max(d.train.x.shape[0] for d in datasets)
    tables = [_table(d.train, device) for d in local]
    xs = stack([t[0] for t in tables], n_max)
    ms = stack([t[1] for t in tables], n_max)
    params_ens = (_stacked_init(model, cfg, xs.shape[2],
                                [epoch_seed(cfg.seed, i)
                                 for i in range(rows.lo, rows.hi)], device)
                  if params is None else _local_params(params, rows, device))
    run_chunk = _make_ensemble_chunk(
        cfg, model, xs, ms, mode="split", S=rows.local,
        noise=_rank_noise(EnsembleNoise("split", device, seed=cfg.seed,
                                        S=rows.padded)
                          if noise is None else noise, rows, "split", cfg,
                          model))
    val_fn = None
    if early_stopping is not None:
        vn_max = max(_val_split(d).x.shape[0] for d in datasets)
        vtables = [_table(_val_split(d), device) for d in local]
        val_fn = _make_ensemble_val_fn(
            cfg, model, stack([t[0] for t in vtables], vn_max),
            stack([t[1] for t in vtables], vn_max),
            GeneratorNoise(cfg.seed, device) if val_noise is None
            else val_noise, per_replica_data=True)
    params_ens, hist = _run_chunked(
        run_chunk, params_ens, cfg.epoch, chunk_epochs,
        resume_path=resume_path, checkpoint_every=checkpoint_every,
        resume=resume,
        resume_tag=(f"split:S={S}:n_seeds={n_seeds}:seed={cfg.seed}"
                    + f":batch={cfg.batch_size}"),
        val_fn=val_fn, early_stopping=early_stopping, rows=rows)
    return _take_rows(params_ens, S), hist[:S]


def train_alpha_ensemble(dataset, cfg: RunConfig, alphas,
                         chunk_epochs: int = 200, seed: int = 0,
                         checkpoint_every=None, resume=False,
                         resume_path=None, early_stopping=None,
                         device="cuda", noise=None, params=None,
                         val_noise=None, mesh=None):
    """Train the reference's alpha sweep (src/experiment_main/
    imputation.py:24) as one ensemble, a replica per alpha (sweep.py:
    635-683). Replica i starts from a generator seeded with
    `train.epoch_seed(seed, i)`; the replicas share the data, the shuffle
    and every stream, so alpha is the only difference between them.
    Returns (params [A, ...], loss history [A, epochs]). With `mesh`, the
    alphas are padded by repeating the last and dp-sharded."""
    model = get_model(cfg)
    alphas = list(alphas)
    S = len(alphas)
    tag = ("alpha:" + ",".join(str(a) for a in alphas)
           + f":seed={seed}:batch={cfg.batch_size}")
    rows, device = _ensemble_rows(mesh, S, device)
    local_alphas = _padded(alphas, rows)[rows.lo:rows.hi]
    params_ens = (_stacked_init(model, cfg, dataset.obs_dim,
                                [epoch_seed(seed, i)
                                 for i in range(rows.lo, rows.hi)], device)
                  if params is None else _local_params(params, rows, device))
    cfg_seeded = cfg.replace(seed=seed)
    x, m = _table(dataset.train, device)
    run_chunk = _make_ensemble_chunk(
        cfg_seeded, model, x, m, mode="alpha", S=rows.local,
        alphas=local_alphas,
        noise=EnsembleNoise("alpha", device, seed=seed, S=rows.padded)
        if noise is None else noise)
    val_fn = None
    if early_stopping is not None:
        val_fn = _shared_table_val_fn(dataset, cfg_seeded, model, device,
                                       val_noise, alphas=local_alphas)
    params_ens, hist = _run_chunked(
        run_chunk, params_ens, cfg.epoch, chunk_epochs,
        resume_path=resume_path, checkpoint_every=checkpoint_every,
        resume=resume, resume_tag=tag, val_fn=val_fn,
        early_stopping=early_stopping, rows=rows)
    return _take_rows(params_ens, S), hist[:S]


def train_alpha_seed_ensemble(dataset, cfg: RunConfig, alphas, seeds,
                              chunk_epochs: int = 200, checkpoint_every=None,
                              resume=False, resume_path=None,
                              early_stopping=None, device="cuda", noise=None,
                              params=None, val_noise=None, mesh=None):
    """The alpha sweep with error bars (sweep.py:686-731): row a * n_seeds +
    i holds (alphas[a], seeds[i]). Rows use the seed mode's streams keyed by
    the row's seed, so the rows of one seed share init, shuffle and draws
    across alphas (a paired comparison) and different seeds are
    independent; alphas=[cfg.alpha] is train_seed_ensemble. Returns
    (params [A*S, ...], loss history [A*S, epochs]). With `mesh`, the rows
    are padded by repeating the last and dp-sharded."""
    model = get_model(cfg)
    rows_v = [(float(a), int(sd)) for a in alphas for sd in seeds]
    R = len(rows_v)
    tag = ("alphaseed:" + ";".join(f"{a}x{sd}" for a, sd in rows_v)
           + f":batch={cfg.batch_size}")
    rows, device = _ensemble_rows(mesh, R, device)
    run_rows = _padded(rows_v, rows)
    row_seeds = [sd for _, sd in run_rows]
    local_alphas = [a for a, _ in run_rows][rows.lo:rows.hi]
    params_ens = (_stacked_init(model, cfg, dataset.obs_dim,
                                row_seeds[rows.lo:rows.hi], device)
                  if params is None else _local_params(params, rows, device))
    x, m = _table(dataset.train, device)
    run_chunk = _make_ensemble_chunk(
        cfg, model, x, m, mode="seed", S=rows.local, alphas=local_alphas,
        noise=_rank_noise(EnsembleNoise("seed", device, seeds=row_seeds)
                          if noise is None else noise, rows, "seed", cfg,
                          model))
    val_fn = None
    if early_stopping is not None:
        val_fn = _shared_table_val_fn(dataset, cfg, model, device,
                                       val_noise, alphas=local_alphas)
    params_ens, hist = _run_chunked(
        run_chunk, params_ens, cfg.epoch, chunk_epochs,
        resume_path=resume_path, checkpoint_every=checkpoint_every,
        resume=resume, resume_tag=tag, val_fn=val_fn,
        early_stopping=early_stopping, rows=rows)
    return _take_rows(params_ens, R), hist[:R]


def train_sweep_ensemble(dataset, cfg: RunConfig, missings=None, alphas=None,
                         seeds=None, chunk_epochs: int = 200,
                         checkpoint_every=None, resume=False,
                         resume_path=None, early_stopping=None,
                         device="cuda", noise=None, params=None,
                         val_noise=None, mesh=None):
    """The reference's whole serial sweep, missing rate x alpha x seed
    (src/experiment_main/imputation.py:23-24), as one ensemble of R =
    len(missings) * len(alphas) * len(seeds) rows (sweep.py:734-824).

    Row (mi * A + ai) * S + si holds (missings[mi], alphas[ai], seeds[si]).
    Returns (params, history, rows), `rows` the [(missing, alpha, seed or
    None)] labels in row order. p_missingness enters only the mask_p draw,
    at each row's own threshold. seeds=None: every row shares the data and
    streams (the alpha mode: the rates' masks nest, the same uniforms at
    different thresholds), row i's init from `train.epoch_seed(cfg.seed,
    i)`; seeds given: the seed mode's streams keyed by the row's seed. A
    single missing rate delegates to train_alpha_seed_ensemble /
    train_alpha_ensemble. With `mesh`, the rows are padded by repeating the
    last and dp-sharded."""
    missings = [int(m) for m in
                (missings if missings is not None else [cfg.p_missingness])]
    alphas = [float(a) for a in
              (alphas if alphas is not None else [cfg.alpha])]
    labels = [(m, a, None if seeds is None else int(s))
              for m in missings for a in alphas
              for s in (seeds if seeds is not None else [None])]
    common = dict(chunk_epochs=chunk_epochs,
                  checkpoint_every=checkpoint_every, resume=resume,
                  resume_path=resume_path, early_stopping=early_stopping,
                  device=device, noise=noise, params=params,
                  val_noise=val_noise, mesh=mesh)
    if len(missings) == 1:
        cfg1 = cfg.replace(p_missingness=missings[0])
        if seeds is not None:
            params, hist = train_alpha_seed_ensemble(dataset, cfg1, alphas,
                                                     seeds, **common)
        else:
            params, hist = train_alpha_ensemble(dataset, cfg1, alphas,
                                                seed=cfg.seed, **common)
        return params, hist, labels
    model = get_model(cfg)
    R = len(labels)
    rows, device = _ensemble_rows(mesh, R, device)
    run_rows = _padded(labels, rows)
    local = run_rows[rows.lo:rows.hi]
    row_miss = [m for m, _, _ in local]
    row_alphas = [a for _, a, _ in local]
    if seeds is not None:
        row_seeds = [s for _, _, s in run_rows]
        init_seeds, mode = row_seeds[rows.lo:rows.hi], "seed"
        default_noise = EnsembleNoise("seed", device, seeds=row_seeds)
    else:
        init_seeds = [epoch_seed(cfg.seed, i)
                      for i in range(rows.lo, rows.hi)]
        mode = "alpha"
        default_noise = EnsembleNoise("alpha", device, seed=cfg.seed,
                                      S=rows.padded)
    params_ens = (_stacked_init(model, cfg, dataset.obs_dim, init_seeds,
                                device)
                  if params is None else _local_params(params, rows, device))
    x, m = _table(dataset.train, device)
    run_chunk = _make_ensemble_chunk(
        cfg, model, x, m, mode=mode, S=rows.local, alphas=row_alphas,
        missings=row_miss,
        noise=_rank_noise(default_noise if noise is None else noise, rows,
                          mode, cfg, model))
    val_fn = None
    if early_stopping is not None:
        val_fn = _shared_table_val_fn(dataset, cfg, model, device,
                                       val_noise, alphas=row_alphas,
                                       missings=row_miss)
    params_ens, hist = _run_chunked(
        run_chunk, params_ens, cfg.epoch, chunk_epochs,
        resume_path=resume_path, checkpoint_every=checkpoint_every,
        resume=resume,
        resume_tag=("sweep:" + ";".join(f"{m},{a},{s}" for m, a, s in labels)
                    + f":batch={cfg.batch_size}"),
        val_fn=val_fn, early_stopping=early_stopping, rows=rows)
    return _take_rows(params_ens, R), hist[:R], labels

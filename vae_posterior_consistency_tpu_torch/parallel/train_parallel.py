"""Multi-device training: the dp/tp-sharded train step and the training
loop over a (dp, tp) mesh (port of the JAX package's
`parallel/train_parallel.py`).

One process a device (`parallel/multihost`), every rank running the same
loop on the same replicated table:

- dp: a step's global batch of `bsz` rows is drawn on every rank (the same
  permutation: every rank's noise source draws the same numbers); dp rank
  r takes rows [r * bsz / dp, (r + 1) * bsz / dp). The step's noise is
  drawn at the global batch's shape and each rank takes its rows along each
  kind's row axis (`ModelDef.train_noise_rows`, `ENGINE_NOISE_ROWS`,
  `parallel/mesh.RankRows`), so the
  ranks together draw what one device would. `train_loss` divides by its
  own row count and the shards are equal, so the mean of the ranks'
  gradients over the dp group (one all-reduce a step, the loss with them)
  is the global batch's gradient; the tp ranks of one dp index hold the
  same rows and are not summed.
- tp: each rank stores only its shard of the leaves `parallel/mesh.
  param_sharding_rule` shards, and of their Adam moments (DTensors on the
  mesh; torch's Adam steps them shard by shard). A step gathers them to full
  tensors (`mesh.full_params`, autograd-aware) before the model's forward,
  so the model code and the kernels see plain tensors (ROADMAP C.4.23).

The loop keeps the JAX package's contract (train_parallel.py:118-295):
bsz = max(min(batch_size, n) // dp * dp, dp) rows a step, the epoch's
permutation tiled when n < bsz, the loss given the 1-based epoch, the
history one number an epoch (the sum of its steps' global losses), resume
files and early stopping as in the serial engine. The decisions that end
a loop come from rank 0 (a validation loss and its stop are broadcast),
and only rank 0 writes the checkpoint and the resume file, from gathered
full tensors, so both are mesh-independent.

Noise: `noise(kind, epoch, step, shape)` as in `engine/train`; the default
is the serial engine's, `GeneratorNoise(cfg.seed + 1, device)`, and fresh
parameters come from a generator seeded with cfg.seed, so at dp = tp = 1
the sharded loop draws what `train.train` draws. (JAX's key schedule here
differs from its serial engine's: key0 = PRNGKey(seed) initialises, epoch e
uses fold_in(key0, e + 1); the tests replay it.)
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.engine import checkpoint
from vae_posterior_consistency_tpu_torch.engine.train import (
    GeneratorNoise,
    _build_val_fn,
    draw_step,
    make_optimizer,
)
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.parallel import mesh as meshlib
from vae_posterior_consistency_tpu_torch.parallel import multihost

#: the batch-row axis of the engine's own draws (`engine/train.draw_step`):
#: the mask_p uniforms [B, D] and the EDDI drop uniforms [2, B, D]
ENGINE_NOISE_ROWS = {"mask_p": 0, "drop": 1}


def _dp_mean(params, loss: torch.Tensor, mesh) -> torch.Tensor:
    """Average the local gradients of `params` and `loss` over the dp group
    in one all-reduce (in place); returns the global loss."""
    from torch.distributed.tensor import DTensor

    grads = [p.grad for p in checkpoint.flatten(params).values()
             if p.grad is not None]
    local = [g.to_local() if isinstance(g, DTensor) else g for g in grads]
    flat = torch.cat([t.reshape(-1) for t in local] + [loss.reshape(1)])
    dist.all_reduce(flat, group=mesh.group("dp"))
    flat /= mesh.shape["dp"]
    offset = 0
    for t in local:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return flat[-1]


def _load_adam_state(optimizer, params, state: checkpoint.AdamState,
                     mesh) -> None:
    """Fill `optimizer` (over the DTensor leaves `params`) with the full
    moments of `state`, each sharded as its parameter is."""
    from torch.distributed.tensor import distribute_tensor

    if state.count == 0:
        return
    mu, nu = checkpoint.flatten(state.mu), checkpoint.flatten(state.nu)
    for key, p in checkpoint.flatten(params).items():
        optimizer.state[p] = {
            "step": torch.tensor(float(state.count)),
            "exp_avg": distribute_tensor(mu[key].to(mesh.device),
                                         mesh.device_mesh, p.placements),
            "exp_avg_sq": distribute_tensor(nu[key].to(mesh.device),
                                            mesh.device_mesh, p.placements),
        }


def gathered(params) -> dict:
    """Detached full tensors of (DTensor) `params`; every rank calls it."""
    return checkpoint.unflatten({k: v.detach() for k, v in checkpoint.flatten(
        meshlib.full_params(params)).items()})


def gathered_adam_state(optimizer, params) -> checkpoint.AdamState:
    """The optimizer's state with its moments gathered to full tensors."""
    state = checkpoint.adam_state(optimizer, params)
    return checkpoint.AdamState(state.count, gathered(state.mu),
                                gathered(state.nu))


def make_parallel_train_step(cfg: RunConfig, mesh, model=None):
    """(sharded_step, shard_inputs) for one optimizer step over `mesh`:

    shard_inputs(params, opt_state=None) -> (params, optimizer): full
      parameters (the same on every rank) as trainable DTensors laid out by
      the tp rule, and Adam over them, filled from a full AdamState;
    sharded_step(params, optimizer, x, mask, noise, epoch, step) -> loss:
      one step on the global batch (x, mask) [bsz, D], the same on every
      rank, of which this rank computes its dp rows; the global loss (a
      detached 0-d tensor on the device, the dp mean of the ranks')."""
    model = model or get_model(cfg)
    dp, r = mesh.shape["dp"], mesh.rank("dp")
    rows = {**ENGINE_NOISE_ROWS, **model.train_noise_rows(cfg)}

    def shard_inputs(params, opt_state=None):
        sharded = meshlib.shard_params(params, mesh)
        for leaf in checkpoint.flatten(sharded).values():
            leaf.requires_grad_(True)
        optimizer = make_optimizer(sharded)
        if opt_state is not None:
            _load_adam_state(optimizer, sharded, opt_state, mesh)
        return sharded, optimizer

    def sharded_step(params, optimizer, x, mask, noise, epoch, step):
        b = x.shape[0] // dp
        x_r, m_r = x[r * b:(r + 1) * b], mask[r * b:(r + 1) * b]
        eff_mask, mask_p, eps, extra = draw_step(
            cfg, meshlib.RankRows(noise, rows, dp, r), m_r, epoch, step,
            model)
        optimizer.zero_grad(set_to_none=True)
        loss, _aux = model.train_loss(meshlib.full_params(params), x_r,
                                      eff_mask, mask_p, eps,
                                      float(epoch + 1), cfg, **extra)
        loss.backward()
        loss = _dp_mean(params, loss.detach(), mesh)
        optimizer.step()
        return loss

    return sharded_step, shard_inputs


def dryrun_train_step(cfg: RunConfig, mesh, obs_dim: int = 8,
                      batch_per_device: int = 4, seed: int = 0) -> float:
    """One full sharded training step at tiny shapes (random parameters and
    data from `seed`): checks that the dp/tp layout runs on the mesh.
    Returns the loss."""
    model = get_model(cfg)
    device = mesh.device
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init(gen, cfg, obs_dim, device=device)
    B = batch_per_device * mesh.shape["dp"]
    x = torch.rand((B, obs_dim), generator=gen, device=device)
    m = (torch.rand((B, obs_dim), generator=gen, device=device)
         < 0.7).to(torch.float32)
    sharded_step, shard_inputs = make_parallel_train_step(cfg, mesh, model)
    params, optimizer = shard_inputs(params)
    loss = sharded_step(params, optimizer, x, m,
                        GeneratorNoise(seed + 1, device), 0, 0)
    return float(loss)


def train_sharded(dataset, cfg: RunConfig, mesh, chunk_epochs: int = 200,
                  model=None, save: bool = False,
                  experiments_root: str = "experiments",
                  checkpoint_every: Optional[int] = None,
                  resume: bool = False, early_stopping=None, noise=None,
                  params: Optional[dict] = None, val_noise=None,
                  on_step: Optional[Callable] = None):
    """The multi-device training loop; returns (params, history): the
    trained parameters as full tensors on this rank's device (the same on
    every rank) and the per-epoch loss sums of the epochs this call ran
    (a numpy array).

    Every rank of `mesh` calls it with the same arguments. `params` (full
    tensors) replaces the fresh init; `noise`, `val_noise` and `on_step(
    epoch, step, loss)` are `engine/train.train`'s. `checkpoint_every=N`
    writes `<checkpoint>.resume.pt` every N epochs and at the end (the
    serial engine's layout and tag, full tensors: a file any mesh or the
    serial engine resumes), `resume=True` continues from it on every rank,
    re-sharded over this mesh. `early_stopping` validates at every multiple
    of `chunk_epochs` and at the end, with the serial engine's objective
    (`train._build_val_fn`), rank 0's loss and stop decision broadcast; on a
    stop the best check's parameters are returned. With `save`, rank 0
    writes the checkpoint under the serial engine's name, and every rank
    waits for it."""
    model = model or get_model(cfg)
    device = mesh.device
    dp = mesh.shape["dp"]
    split = dataset.train
    x = split.x.to(device=device, dtype=torch.float32)
    mask = split.mask.to(device=device, dtype=torch.float32)
    n = split.n
    # the batch divides over dp; when n < dp the padded epoch needs more
    # than one copy of the permutation, so it is tiled
    bsz = max(min(cfg.batch_size, n) // dp * dp, dp)
    steps = math.ceil(n / bsz)
    pad = steps * bsz - n
    perm_reps = math.ceil((n + pad) / n)

    if params is None:
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        params = model.init(gen, cfg, dataset.obs_dim, device=device)
    params = checkpoint.on_device(params, device)
    noise = GeneratorNoise(cfg.seed + 1, device) if noise is None else noise

    final_path = checkpoint.checkpoint_path(cfg, experiments_root)
    resume_path = final_path + ".resume.pt"
    resume_tag = f"run:{cfg.vae_type}:seed={cfg.seed}:batch={cfg.batch_size}"
    done, opt_state = 0, None
    if resume and os.path.exists(resume_path):
        params, opt_state, done = checkpoint.load_resume(
            params, resume_path, tag=resume_tag, max_epochs=cfg.epoch)
    sharded_step, shard_inputs = make_parallel_train_step(cfg, mesh, model)
    params, optimizer = shard_inputs(params, opt_state)

    val_fn = None
    if early_stopping is not None:
        vsplit = dataset.test if dataset.test is not None else dataset.train
        val_fn = _build_val_fn(
            cfg, model, vsplit.x.to(device=device, dtype=torch.float32),
            vsplit.mask.to(device=device, dtype=torch.float32),
            noise if val_noise is None else val_noise)

    def run_epoch(epoch: int) -> float:
        perm = noise("perm", epoch, 0, (n,)).to(device)
        if pad:
            perm = perm.repeat(perm_reps)[:n + pad]
        x_e, m_e = x[perm], mask[perm]
        total = torch.zeros((), device=device)
        for s in range(steps):
            rows = slice(s * bsz, (s + 1) * bsz)
            loss = sharded_step(params, optimizer, x_e[rows], m_e[rows],
                                noise, epoch, s)
            total += loss
            if on_step is not None:
                on_step(epoch, s, loss)
        return total.item()

    def check(full) -> bool:
        """Rank 0's validation loss and stop decision, on every rank."""
        vloss = val_fn(full)
        stop = (early_stopping.update(vloss, full)
                if multihost.is_coordinator() else False)
        msg = torch.tensor([vloss, float(stop)], dtype=torch.float64,
                           device=device)
        dist.broadcast(msg, src=0)
        if not multihost.is_coordinator():
            early_stopping.update(float(msg[0]), full)
        return bool(msg[1])

    history = []
    while done < cfg.epoch:
        n_e = min(chunk_epochs, cfg.epoch - done)
        if checkpoint_every:
            n_e = min(n_e, checkpoint_every - done % checkpoint_every)
        if val_fn is not None:
            n_e = min(n_e, chunk_epochs - done % chunk_epochs)
        for epoch in range(done, done + n_e):
            history.append(run_epoch(epoch))
        done += n_e
        if checkpoint_every and (done % checkpoint_every == 0
                                 or done >= cfg.epoch):
            full, adam = gathered(params), gathered_adam_state(optimizer,
                                                               params)
            if multihost.is_coordinator():
                checkpoint.save_resume(full, adam, done, resume_path,
                                       tag=resume_tag)
        if val_fn is not None and (done % chunk_epochs == 0
                                   or done >= cfg.epoch):
            if check(gathered(params)):
                break

    params = gathered(params)
    if early_stopping is not None and early_stopping.best_params is not None:
        params = early_stopping.best_params
    if save:
        if multihost.is_coordinator():
            checkpoint.save(params, final_path)
        multihost.barrier(device)
    return params, np.asarray(history)

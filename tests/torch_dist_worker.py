"""Rank workers of the port's multi-process tests
(`tests/test_torch_parallel.py`, `tests/test_torch_eval_sharded.py`).

`spawn(jobs, world, tmp_path)` starts `world` processes with
`torch.multiprocessing.spawn`; each joins a gloo process group on a file
store in `tmp_path` (no TCP port, so parallel test workers cannot collide),
runs the jobs in order and saves what each returned; `spawn` returns the
ranks' results. A job is (name, kwargs), `name` a function of `JOBS`.

The module imports torch, numpy and the port only: the ranks never import
JAX. The tests make JAX's parameters and draws in the parent and hand them
over as numpy arrays; `Recorded` replays the draws as a port noise source.
"""

from __future__ import annotations

import contextlib
import io
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.data import loaders as tloaders
from vae_posterior_consistency_tpu_torch.engine import artifacts as tart
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.engine import evaluate_sharded
from vae_posterior_consistency_tpu_torch.parallel import mesh as tmesh
from vae_posterior_consistency_tpu_torch.parallel import train_parallel
from vae_posterior_consistency_tpu_torch.utils.early_stopping import (
    EarlyStopping,
)


class Recorded:
    """A port noise source replaying recorded draws:
    draws[(kind, epoch, step, shape)] -> numpy array."""

    def __init__(self, draws):
        self.draws = draws

    def __call__(self, kind, epoch, step, shape):
        drawn = torch.from_numpy(
            np.asarray(self.draws[(kind, epoch, step, tuple(shape))]))
        return drawn.long() if kind == "perm" else drawn


def dataset(x, mask, x_test=None, mask_test=None):
    """A port Dataset of numpy arrays (train, and test when given)."""
    def split(a, m, stage):
        return tloaders.Split(torch.from_numpy(a), torch.from_numpy(m), stage)

    return tloaders.Dataset(
        split(x, mask, "train"),
        None if x_test is None else split(x_test, mask_test, "test"),
        x.shape[1])


def _flat_numpy(params) -> dict:
    return {k: v.detach().cpu().numpy()
            for k, v in tckpt.flatten(params).items()}


@contextlib.contextmanager
def _counting(module, name, counts):
    """`module.name` wrapped to count its calls in counts[name]."""
    fn = getattr(module, name)
    counts[name] = 0

    def wrapped(*a, **kw):
        counts[name] += 1
        return fn(*a, **kw)

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def job_step(cfg, mesh_shape, params, x, mask, draws):
    """One `make_parallel_train_step` step on the global batch (x, mask):
    the global loss, the parameters after it (gathered), and the local
    shapes on this rank of each leaf and of its Adam moments."""
    mesh = tmesh.make_mesh(dp=mesh_shape[0], tp=mesh_shape[1], device="cpu")
    step, shard_inputs = train_parallel.make_parallel_train_step(
        tcfg.RunConfig(**cfg), mesh)
    sharded, optimizer = shard_inputs(
        tckpt.params_from_jax(params, "cpu"))
    loss = step(sharded, optimizer, torch.from_numpy(x),
                torch.from_numpy(mask), Recorded(draws), 0, 0)
    leaves = tckpt.flatten(sharded)
    return {"loss": float(loss),
            "local": {k: tuple(v.to_local().shape)
                      for k, v in leaves.items()},
            "moments": {f"{k}/{m}": tuple(
                optimizer.state[v][m].to_local().shape)
                        for k, v in leaves.items()
                        for m in ("exp_avg", "exp_avg_sq")},
            "params": _flat_numpy(train_parallel.gathered(sharded))}


def job_host_data(rows):
    """`multihost.shard_host_data` of this rank's `rows` of a [world *
    rows, 3] table on a (world, 1) mesh: the global shape, this rank's
    shard and the gathered table."""
    from vae_posterior_consistency_tpu_torch.parallel import multihost

    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = tmesh.make_mesh(dp=world, tp=1, device="cpu")
    table = torch.arange(world * rows * 3, dtype=torch.float32).reshape(-1, 3)
    local = table[rank * rows:(rank + 1) * rows]
    global_ = multihost.shard_host_data(mesh, local)
    return {"shape": tuple(global_.shape),
            "local": global_.to_local().numpy(),
            "full": global_.full_tensor().numpy(),
            "coordinator": multihost.is_coordinator()}


def job_train(cfg, mesh_shape, data, params=None, draws=None, root=None,
              val_draws=None, patience=None, runs=None, chunk_epochs=200):
    """`train_sharded` on `data` (dataset's arguments): the history, the
    gathered parameters and how often this rank wrote a checkpoint or a
    resume file. `runs` is a list of (epoch, checkpoint_every, resume)
    made one after the other in `root` (the last one's results kept);
    `patience` adds early stopping (delta 1e9)."""
    mesh = tmesh.make_mesh(dp=mesh_shape[0], tp=mesh_shape[1], device="cpu")
    ds = dataset(*data)
    base = tcfg.RunConfig(**cfg)
    counts = {}
    out = {}
    for epoch, ck, rs in runs or [(base.epoch, None, False)]:
        es = (None if patience is None
              else EarlyStopping(patience=patience, delta=1e9))
        with _counting(tckpt, "save", counts), \
                _counting(tckpt, "save_resume", counts):
            got, hist = train_parallel.train_sharded(
                ds, base.replace(epoch=epoch), mesh, save=root is not None,
                experiments_root=root or "experiments",
                checkpoint_every=ck, resume=rs, early_stopping=es,
                noise=None if draws is None else Recorded(draws),
                params=(None if params is None
                        else tckpt.params_from_jax(params, "cpu")),
                val_noise=None if val_draws is None else Recorded(val_draws),
                chunk_epochs=chunk_epochs)
        out = {"hist": np.asarray(hist), "params": _flat_numpy(got),
               "saves": dict(counts)}
    return out


def job_dryrun(cfg, mesh_shape):
    mesh = tmesh.make_mesh(dp=mesh_shape[0], tp=mesh_shape[1], device="cpu")
    return {"loss": train_parallel.dryrun_train_step(
        tcfg.RunConfig(**cfg), mesh, obs_dim=8, batch_per_device=4)}


def job_eval(cfg, data, params, draws, root):
    """`eval_vae_sharded` on a dp=2 mesh under the recorded draws, its
    artifacts into `root`: the results and this rank's artifact writes."""
    mesh = tmesh.make_mesh(dp=dist.get_world_size(), tp=1, device="cpu")
    counts = {}
    with _counting(tart, "save_tensor", counts):
        res = evaluate_sharded.eval_vae_sharded(
            dataset(*data), tcfg.RunConfig(**cfg), mesh,
            params=tckpt.params_from_jax(params, "cpu"), experiments_root=root,
            noise=Recorded(draws))
    return {"results": res, "writes": counts["save_tensor"]}


def job_entry(module, argv, workdir):
    """An entry point's `main(argv)` run in `workdir`: its exit code and
    what it printed on this rank."""
    import importlib

    main = importlib.import_module(
        f"vae_posterior_consistency_tpu_torch.experiment_main.{module}").main
    cwd, buf = os.getcwd(), io.StringIO()
    os.chdir(workdir)
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        os.chdir(cwd)
    return {"rc": rc, "out": buf.getvalue()}


JOBS = {"step": job_step, "train": job_train, "dryrun": job_dryrun,
        "eval": job_eval, "entry": job_entry, "host_data": job_host_data}


def _rank(rank, world, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            rank=rank, world_size=world)
    out = []
    try:
        for name, kw in torch.load(os.path.join(tmp, "jobs.pt"),
                                   weights_only=False):
            out.append(JOBS[name](**kw))
    finally:
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
        dist.destroy_process_group()


def spawn(jobs, world, tmp_path):
    """Run `jobs` on `world` gloo ranks; returns [rank][job] results."""
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    torch.save(list(jobs), os.path.join(tmp, "jobs.pt"))
    mp.spawn(_rank, args=(world, tmp), nprocs=world, join=True)
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]

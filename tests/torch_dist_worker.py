"""Rank workers of the port's multi-process tests
(`tests/test_torch_parallel.py`, `tests/test_torch_eval_sharded.py`,
`tests/test_torch_mesh_sweep.py`, `tests/test_torch_mesh_al_ais.py`).

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
    """A port noise source replaying recorded draws: draws[(kind, *args,
    shape)] -> numpy array, for a source called as `noise(kind, *args,
    shape)` (training's (kind, epoch, step, shape), AIS's (kind, t,
    shape), serving's (kind, ctr, shape)); keyword arguments are ignored.
    An ensemble source's `epoch(e, n, steps, shapes)` returns epochs[e]."""

    def __init__(self, draws=None, epochs=None):
        self.draws, self.epochs = draws, epochs

    def __call__(self, kind, *args, **kw):
        key = (kind, *args[:-1], tuple(args[-1]))
        drawn = torch.from_numpy(np.asarray(self.draws[key]))
        return drawn.long() if kind == "perm" else drawn

    def epoch(self, epoch, n, steps, shapes):
        return {k: torch.from_numpy(np.asarray(v)).long() if k == "perm"
                else torch.from_numpy(np.asarray(v))
                for k, v in self.epochs[epoch].items()}


@contextlib.contextmanager
def one_rank_mesh():
    """A (1, 1) mesh on the CPU over a world-size-1 gloo group made for it
    (`config.resolve_mesh`'s), destroyed afterwards."""
    from vae_posterior_consistency_tpu_torch.parallel import multihost

    multihost.ensure_group("cpu")
    try:
        yield tmesh.make_mesh(dp=1, tp=1, device="cpu")
    finally:
        multihost.shutdown()


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
    """An entry point's `main(argv)` run in `workdir`: its exit code, what
    it printed on this rank and how many files it wrote (checkpoints,
    resume files, artifacts and metric lines)."""
    import importlib

    main = importlib.import_module(
        f"vae_posterior_consistency_tpu_torch.experiment_main.{module}").main
    cwd, buf = os.getcwd(), io.StringIO()
    os.chdir(workdir)
    counts = {}
    try:
        with contextlib.redirect_stdout(buf), \
                _counting(tckpt, "save", counts), \
                _counting(tckpt, "save_resume", counts), \
                _counting(tart, "save_tensor", counts), \
                _counting(tart, "log_metric", counts):
            rc = main(argv)
    finally:
        os.chdir(cwd)
    return {"rc": rc, "out": buf.getvalue(), "writes": counts}


def _mesh(mesh_shape):
    return tmesh.make_mesh(dp=mesh_shape[0], tp=mesh_shape[1], device="cpu")


def job_ensemble(trainer, cfg, data, params, epochs, mesh_shape=(2, 1),
                 kwargs=None, val_draws=None, patience=None, runs=None,
                 root=None):
    """`parallel/sweep.<trainer>` on `mesh_shape` from the padded `params`
    under the recorded epoch draws `epochs` (a list of datasets' arguments
    for the split trainer, one dataset's otherwise): the history, the
    parameters and this rank's resume-file writes. `runs` is a list of
    (epoch, checkpoint_every, resume) made one after the other with the
    resume file in `root`; `patience` adds the per-replica early stopper
    (delta 1e9) under the recorded validation draws."""
    from vae_posterior_consistency_tpu_torch.parallel import sweep
    from vae_posterior_consistency_tpu_torch.utils.early_stopping import (
        EnsembleEarlyStopping,
    )

    mesh = _mesh(mesh_shape)
    base = tcfg.RunConfig(**cfg)
    ds = ([dataset(*d) for d in data] if trainer == "train_split_ensemble"
          else dataset(*data))
    counts, out = {}, {}
    for epoch, ck, rs in runs or [(base.epoch, None, False)]:
        es = (None if patience is None
              else EnsembleEarlyStopping(patience=patience, delta=1e9))
        extra = {}
        if root is not None:
            extra = dict(checkpoint_every=ck, resume=rs,
                         resume_path=os.path.join(root, "ens.resume.pt"))
        with _counting(tckpt, "save_resume", counts):
            got = getattr(sweep, trainer)(
                ds, base.replace(epoch=epoch), **(kwargs or {}), mesh=mesh,
                noise=Recorded(epochs=epochs),
                params=tckpt.params_from_jax(params, "cpu"),
                val_noise=None if val_draws is None else Recorded(val_draws),
                early_stopping=es, chunk_epochs=2 if es else 200,
                device="cpu", **extra)
        out = {"hist": np.asarray(got[1]), "params": _flat_numpy(got[0]),
               "rows": got[2] if len(got) > 2 else None,
               "saves": dict(counts),
               "best": None if es is None else es.best_loss}
    return out


def job_al(cfg, x, params, draws, root, ensemble=False, repeat=1):
    """`active_learning_func` (or `_ensemble` of stacked `params`) on a
    dp = world mesh under the recorded draws, saved into `root`: the
    artifacts and this rank's writes."""
    from vae_posterior_consistency_tpu_torch.engine import active_learning

    mesh = _mesh((dist.get_world_size(), 1))
    c = tcfg.RunConfig(**cfg)
    p = tckpt.params_from_jax(params, "cpu")
    counts = {}
    with _counting(tart, "save_tensor", counts):
        if ensemble:
            out = active_learning.active_learning_ensemble(
                x, np.ones_like(x), c, p, experiments_root=root,
                Repeat=repeat, noise=Recorded(draws), mesh=mesh,
                device="cpu")
        else:
            out = active_learning.active_learning_func(
                None, x, np.ones_like(x), c, experiments_root=root,
                Repeat=repeat, params=p, noise=Recorded(draws), mesh=mesh,
                device="cpu")
    return {"out": {k: v.numpy() for k, v in out.items()},
            "writes": counts["save_tensor"]}


def job_ais(fn, cfg, params, draws, data=None, root=None, n_sample=3,
            T=5, n_batch=None):
    """One AIS driver of `engine/ais` on a dp = world mesh under recorded
    draws: `ais_batch` and `bdmc` of the family's bridge (`data` the
    rows of `ais_batch`), or `eval_ais`, `eval_ais_ensemble` (`draws` a
    list, a split each) and `eval_bdmc` on the dataset `data`, saving into
    `root`. Returns the estimates (and latents), this rank's writes and
    each of its chain steps' (accept probabilities, uniforms)."""
    from vae_posterior_consistency_tpu_torch.engine import ais

    mesh = _mesh((dist.get_world_size(), 1))
    c = tcfg.RunConfig(**cfg)
    p = tckpt.params_from_jax(params, "cpu")
    sched = ais.linear_schedule(T)
    bridge = ais.bridge_for(c)
    counts, steps = {}, []
    real_step = ais.ais_step

    def step(ll_fn, state, t0, t1, v, u, leapfrog=10):
        out, prob = real_step(ll_fn, state, t0, t1, v, u, leapfrog)
        steps.append((prob.numpy(), u.numpy()))
        return out, prob

    ais.ais_step = step
    try:
        with _counting(tart, "save_tensor", counts):
            if fn in ("ais_batch", "bdmc"):
                ll = lambda z, x: bridge.log_lik(p, z, x)  # noqa: E731
                if fn == "ais_batch":
                    res = ais.ais_batch(None, torch.from_numpy(data),
                                        n_sample, c.latent_dim, sched,
                                        Recorded(draws), mesh=mesh,
                                        log_lik_fn=ll)
                else:
                    res = ais.bdmc(
                        None, n_batch, n_sample, c.latent_dim, sched,
                        Recorded(draws), mesh=mesh, log_lik_fn=ll,
                        sample_fn=lambda z, src: bridge.sample_x(p, z, src))
            elif fn == "eval_bdmc":
                res = ais.eval_bdmc(dataset(*data), c, params=p,
                                    schedule=sched, n_sample=n_sample,
                                    noise=Recorded(draws),
                                    experiments_root=root, mesh=mesh,
                                    device="cpu")
            else:
                srcs = [Recorded(d) for d in draws]
                res = getattr(ais, fn)(
                    dataset(*data), c, p, schedule=sched, n_sample=n_sample,
                    noise=lambda i: srcs[i], experiments_root=root,
                    mesh=mesh, device="cpu")
    finally:
        ais.ais_step = real_step
    if isinstance(res, dict):
        out = {stage: {"logw": r.logw, "latents": r.latents}
               for stage, r in res.items()}
    elif hasattr(res, "lower"):
        out = {"lower": res.lower, "upper": res.upper}
    else:
        out = {"logw": res.logw, "latents": res.latents}
    return {"out": out, "writes": counts.get("save_tensor", 0),
            "steps": steps}


def job_serve(cfg, params, obs_dim, buckets, requests, draws):
    """An `ImputationServer` on a dp = world mesh under recorded draws:
    each request's (filled, row_score), and the server's buckets."""
    from vae_posterior_consistency_tpu_torch.engine import serve

    mesh = _mesh((dist.get_world_size(), 1))
    srv = serve.ImputationServer(
        tckpt.params_from_jax(params, "cpu"), tcfg.RunConfig(**cfg),
        obs_dim, buckets=buckets, noise=Recorded(draws), mesh=mesh)
    return {"out": [srv.impute(x, m) for x, m in requests],
            "buckets": srv.buckets}


def job_http(cfg, params, obs_dim, requests):
    """`serve_http`'s protocol on a dp = world mesh: rank 0 binds a free
    port, posts `requests` to itself and stops the others, which follow.
    Returns rank 0's answers and each rank's count of requests served."""
    import json
    import threading
    import urllib.request

    from vae_posterior_consistency_tpu_torch.engine import serve

    mesh = _mesh((dist.get_world_size(), 1))
    srv = serve.ImputationServer(
        tckpt.params_from_jax(params, "cpu"), tcfg.RunConfig(**cfg),
        obs_dim, buckets=(4,), mesh=mesh)
    if dist.get_rank() != 0:
        return {"served": srv.follow()}
    httpd = serve.make_http_server(srv, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    answers = []
    try:
        for x, m in requests:
            req = urllib.request.Request(
                f"http://127.0.0.1:{httpd.server_address[1]}/impute",
                data=json.dumps({"x": x.tolist(), "mask": m.tolist()}
                                ).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                answers.append(json.loads(resp.read()))
    finally:
        httpd.shutdown()
        httpd.server_close()
        serve.stop_followers(srv)
    return {"served": len(answers), "answers": answers}


def job_dryrun_multichip():
    from vae_posterior_consistency_tpu_torch.parallel import dryrun

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        line = dryrun.dryrun_multichip(dist.get_world_size(), device="cpu")
    return {"line": line, "out": buf.getvalue()}


JOBS = {"step": job_step, "train": job_train, "dryrun": job_dryrun,
        "eval": job_eval, "entry": job_entry, "host_data": job_host_data,
        "ensemble": job_ensemble, "al": job_al, "ais": job_ais,
        "serve": job_serve, "http": job_http,
        "dryrun_multichip": job_dryrun_multichip}


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

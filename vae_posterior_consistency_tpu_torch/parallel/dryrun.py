"""A dry run of every mesh path at tiny shapes (the port's analog of the
JAX package's `__graft_entry__.dryrun_multichip`).

Every rank of an n-rank process group calls `dryrun_multichip(n)`; a run
without a group makes a world-size-1 one (`multihost.ensure_group`). It
builds the (dp, tp) mesh `factor_devices(n)` gives and runs, each once and
with the JAX function's asserts: one sharded training step, a short
sharded training loop that must learn, the sharded evaluation, a seed
ensemble of 2*dp replicas trained as groups of dp, per-replica early
stopping, the split triple seed-replicated to 6 rows and its vmapped
evaluation, the (missing rate x alpha) sweep, serving, one active-learning
episode on 2*dp rows and AIS with 2*dp chains a row. Rank 0 prints the
one-line summary, which the call also returns.

    torchrun --standalone --nproc_per_node 2 -m \\
        vae_posterior_consistency_tpu_torch.parallel.dryrun 2 --device cpu
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch
import torch.distributed as dist

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.data.loaders import Dataset, Split
from vae_posterior_consistency_tpu_torch.engine import ais as ais_engine
from vae_posterior_consistency_tpu_torch.engine.active_learning import (
    active_learning_func,
)
from vae_posterior_consistency_tpu_torch.engine.evaluate import (
    eval_vae_ensemble,
)
from vae_posterior_consistency_tpu_torch.engine.evaluate_sharded import (
    eval_vae_sharded,
)
from vae_posterior_consistency_tpu_torch.engine.serve import ImputationServer
from vae_posterior_consistency_tpu_torch.parallel import mesh as meshlib
from vae_posterior_consistency_tpu_torch.parallel import multihost, sweep
from vae_posterior_consistency_tpu_torch.parallel.train_parallel import (
    dryrun_train_step,
    train_sharded,
)
from vae_posterior_consistency_tpu_torch.utils.early_stopping import (
    EnsembleEarlyStopping,
)


def _finite(values) -> bool:
    return bool(np.isfinite(np.asarray(values, dtype=np.float64)).all())


def dryrun_multichip(n_devices: int, device="cuda") -> str:
    """Run every mesh path once on an n_devices-rank mesh (see the module
    docstring); every rank calls it. Returns the summary line."""
    multihost.ensure_group(device)
    world = dist.get_world_size()
    assert world == n_devices, f"need {n_devices} ranks, have {world}"
    dp, tp = meshlib.factor_devices(n_devices)
    mesh = meshlib.make_mesh(dp=dp, tp=tp, device=device)
    dev = mesh.device
    cfg = RunConfig().replace(hid_dim=256)
    loss = dryrun_train_step(cfg, mesh, obs_dim=8, batch_per_device=4)
    assert math.isfinite(loss), f"non-finite dry-run loss: {loss}"

    # a short training loop through the CLI's sharded path
    n, obs_dim = 64, 8
    gen = torch.Generator(device=dev).manual_seed(42)
    x = torch.rand((n, obs_dim), generator=gen, device=dev)
    m = (torch.rand((n, obs_dim), generator=gen, device=dev)
         < 0.7).to(torch.float32)
    ds = Dataset(train=Split(x, m, "train"), test=None, obs_dim=obs_dim)
    loop_cfg = cfg.replace(epoch=8, batch_size=16)
    sh_params, hist = train_sharded(ds, loop_cfg, mesh, chunk_epochs=8)
    assert hist.shape == (8,) and _finite(hist), hist
    assert hist[-1] < hist[0], f"sharded loop did not learn: {hist}"

    # the sharded evaluation
    ds_eval = Dataset(train=Split(x, m, "train"),
                      test=Split(x[:24], m[:24], "test"), obs_dim=obs_dim)
    ev = eval_vae_sharded(ds_eval, loop_cfg, mesh, params=sh_params,
                          save=False)
    assert set(ev) == {"train", "test"}
    for stage, metrics in ev.items():
        assert _finite(list(metrics.values())), (stage, metrics)

    # a seed ensemble dp-sharded, trained as groups of dp replicas
    ens_cfg = loop_cfg.replace(epoch=4, hid_dim=64)
    saved = sweep.SEED_GROUP_MAX_S
    try:
        sweep.SEED_GROUP_MAX_S = dp
        _, ens_hist = sweep.train_seed_ensemble(
            ds, ens_cfg, seeds=list(range(2 * dp)), mesh=mesh,
            chunk_epochs=4)
    finally:
        sweep.SEED_GROUP_MAX_S = saved
    assert ens_hist.shape == (2 * dp, 4) and _finite(ens_hist)

    # per-replica early stopping: the plateau (delta 1e9, patience 1)
    # stops at the second check, epoch 4 of 8
    es = EnsembleEarlyStopping(patience=1, delta=1e9)
    _, es_hist = sweep.train_seed_ensemble(
        ds, ens_cfg.replace(epoch=8), seeds=list(range(dp)), mesh=mesh,
        chunk_epochs=2, early_stopping=es)
    assert es_hist.shape == (dp, 4), es_hist.shape
    assert es.best_params is not None

    # the split triple seed-replicated to 6 rows, padded onto dp, then one
    # vmapped evaluation of the 6 rows
    triple = [ds_eval] * 3
    sp_params, sp_hist = sweep.train_split_ensemble(
        triple, ens_cfg, mesh=mesh, chunk_epochs=4, n_seeds=2)
    assert sp_hist.shape == (6, 4) and _finite(sp_hist)
    ens_cfgs = [ens_cfg.replace(vae_type=f"reg_vae{i + 1}")
                for i in range(3)]
    ens_res = eval_vae_ensemble(triple * 2, ens_cfgs * 2, sp_params,
                                save=False, device=dev)
    assert len(ens_res) == 6
    for res in ens_res:
        for stage, metrics in res.items():
            assert _finite(list(metrics.values())), (stage, metrics)

    # the (missing rate x alpha) sweep: 6 rows padded onto dp
    _, sw_hist, sw_rows = sweep.train_sweep_ensemble(
        ds_eval, ens_cfg, missings=[10, 60], alphas=[0.5, 1.0, 2.0],
        mesh=mesh, chunk_epochs=4)
    assert sw_hist.shape == (6, 4) and _finite(sw_hist)
    assert sw_rows[0] == (10, 0.5, None) and sw_rows[-1] == (60, 2.0, None)

    # serving: parameters replicated, request rows dp-sharded, buckets
    # rounded up to multiples of dp
    srv = ImputationServer(sh_params, loop_cfg, obs_dim, buckets=(1, 16),
                           mesh=mesh)
    filled, score = srv.impute(x[:5].cpu().numpy(), m[:5].cpu().numpy())
    assert filled.shape == (5, obs_dim) and score.shape == (5,)
    assert _finite(filled) and _finite(score)

    # one active-learning episode, its 2*dp test rows dp-sharded
    al_out = active_learning_func(None, x[:2 * dp], m[:2 * dp],
                                  loop_cfg.replace(M=2), Repeat=1,
                                  params=sh_params, save=False, mesh=mesh)
    assert al_out["information_curve"].shape == (1, 2 * dp, obs_dim)
    assert _finite(al_out["information_curve"].cpu())

    # AIS: 4 rows x 2*dp chains dp-sharded
    bridge = ais_engine.bridge_for(loop_cfg)
    ais_res = ais_engine.ais_batch(
        None, x[:4], 2 * dp, loop_cfg.latent_dim,
        ais_engine.linear_schedule(8), ais_engine.GeneratorNoise(9, dev),
        mesh=mesh,
        log_lik_fn=lambda z, xr: bridge.log_lik(sh_params, z, xr))
    assert math.isfinite(ais_res.logw), ais_res.logw
    assert ais_res.latents.shape == (4, 2 * dp, loop_cfg.latent_dim)

    line = (f"dryrun_multichip({n_devices}): mesh={dict(mesh.shape)} "
            f"loss={loss:.4f} loop[{hist[0]:.3f}->{hist[-1]:.3f}] "
            f"sharded-eval[train/test finite] ensemble[{2 * dp}x "
            f"dp-sharded] early-stop[{dp}x stopped@4/8] "
            f"split-ensemble[3x2 seeds padded onto dp={dp} + vmapped eval] "
            f"sweep-ensemble[2x3 missing-x-alpha rows dp-sharded] "
            f"serve[5 rows, bucket {srv.buckets[0]}+] "
            f"al[{2 * dp} rows dp-sharded] "
            f"ais[4x{2 * dp} chains dp-sharded, logw={ais_res.logw:.3f}]")
    with multihost.coordinator_stdout():
        print(line, flush=True)
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    multihost.initialize(args.device)
    try:
        dryrun_multichip(args.n_devices, device=args.device)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

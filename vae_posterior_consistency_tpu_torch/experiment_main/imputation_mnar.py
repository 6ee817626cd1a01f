"""MNAR imputation experiment: train and evaluate every record of
`Data/imputation_args_mnar.json` (port of the serial grid of the JAX
package's `experiment_main/imputation_mnar.py`; reference:
src/experiment_main/imputation_mnar.py:27-85).

    python -m \
        vae_posterior_consistency_tpu_torch.experiment_main.imputation_mnar \
        [-<field> <value> ...] [-device cpu]

Run from the directory that holds `Data/` (the default grids are written
into it first where they are missing, `imputation.start_up`); checkpoints
and artifacts go to `experiments/` there. Each record is parsed with
`config.setup_parser`, so a CLI flag overrides that field in every record
(a `-vae_type` too). For each
record and each (p_missingness, alpha) of the sweep (`-missings`,
`-alphas`; by default 50 and 1.0, as the reference hard-codes them), with
`data_transform` 'minmax' and `not_miwae_type` 'changed' pinned as the
reference pins them, it loads the MNAR table (`data_loader_mnar`: rows
permuted, the target column dropped), trains with `engine/train.train`,
which saves the reference-named checkpoint, evaluates the full matrix with
`engine/evaluate.eval_vae_mnar`, which loads it and writes the artifact,
and prints the RMSE and the wall-clock of both.

The run uses the card (`-device cuda`, the default; it raises without CUDA)
or, with `-device cpu`, the CPU (`imputation.open_grid`, as the MCAR entry
point). `-checkpoint_every`, `-resume` and `-early_stop` reach `train` as
in the JAX package, `-profile DIR` traces the run, with the
program's own spans (`config.maybe_profile`).
`-mesh` resolves per record (`config.resolve_mesh`): with a mesh the
record trains with `parallel/train_parallel.train_sharded` (under torchrun
for more than one device, as `experiment_main/imputation`), its train line
tagged with the mesh, and the MNAR evaluation stays single-program on the
gathered parameters, as in the JAX package (imputation_mnar.py:124-145);
rank 0 alone prints and writes. Beside `-seeds N` and `-ensemble true`
the replica rows are dp-sharded over the mesh (`parallel/sweep`'s
`mesh`), the train line tagged with it, and the ensemble's MNAR
evaluation runs on the gathered parameters.

Ensembles (`parallel/sweep`; the JAX package's experiment_main/
imputation_mnar.py:79-118, 153-283): `-seeds N` trains each (record,
missing, alpha) cell's N seed replicas as one seed ensemble and evaluates
them in one vmapped MNAR evaluation (`_run_seed_ensemble`); `-ensemble
true` trains each record's (missing x alpha x seed) product as one
ensemble and evaluates it a rate at a time (`_run_sweep_ensemble`), a
`-vae_type` flag cutting the grid to that record. Seed 0 keeps the
reference names, seed s saves under `.seed{s}`.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from vae_posterior_consistency_tpu_torch.config import (
    RunConfig,
    early_stopper,
    maybe_profile,
    parse_alphas,
    parse_missings,
    resolve_mesh,
    restart_opts,
    restrict_grid_records,
    setup_parser,
)
from vae_posterior_consistency_tpu_torch.data import loaders
from vae_posterior_consistency_tpu_torch.engine import (
    artifacts,
    checkpoint,
    evaluate,
)
from vae_posterior_consistency_tpu_torch.engine import train as train_engine
from vae_posterior_consistency_tpu_torch.experiment_main.imputation import (
    open_grid,
    wait_for_writes,
)
from vae_posterior_consistency_tpu_torch.parallel import multihost, sweep
from vae_posterior_consistency_tpu_torch.parallel.train_parallel import (
    train_sharded,
)
from vae_posterior_consistency_tpu_torch.utils.logging import epoch_logger

#: the grid, relative to the working directory
GRID = os.path.join("Data", "imputation_args_mnar.json")
#: hard-coded sweep axes (reference: src/experiment_main/imputation_mnar.py:
#: 30-31)
MISSING_SWEEP = [50]
ALPHA_SWEEP = [1.0]
#: pinned in the reference's script body
#: (src/experiment_main/imputation_mnar.py:38-39)
DATA_TRANSFORM = "minmax"
NOT_MIWAE_TYPE = "changed"


def _load(cfg: RunConfig, device):
    return loaders.data_loader_mnar(
        cfg.data_path, cfg.vae_type, cfg.missing_rate, cfg.batch_size,
        cfg.data_type, data_transform=DATA_TRANSFORM, device=device)


def run_grid(records, probe, argv) -> None:
    """The grid: each record x missing x alpha trained, saved, evaluated
    and printed (each cell's `-seeds N` replicas as one seed ensemble);
    with `-ensemble true` each record's sweep as one ensemble."""
    alphas = parse_alphas(probe, ALPHA_SWEEP)
    missings = parse_missings(probe, MISSING_SWEEP)
    if bool(getattr(probe, "ensemble", False)):
        print("[ensemble mode] MNAR sweeps run as vmapped ensembles; PRNG "
              "streams differ from the serial path (PARITY.md deviation "
              "#8)", flush=True)
        for record in restrict_grid_records(records, probe):
            _run_sweep_ensemble(record, argv, missings, alphas)
        return
    for record in records:
        for missing in missings:
            for alpha in alphas:
                args = setup_parser(record, "impute_eval").parse_args(argv)
                cfg = RunConfig.from_args(args, alpha=alpha,
                                          p_missingness=missing,
                                          data_transform=DATA_TRANSFORM,
                                          not_miwae_type=NOT_MIWAE_TYPE)
                dataset = _load(cfg, args.device)
                mesh = resolve_mesh(cfg, device=args.device)
                tag = f" mesh={dict(mesh.shape)}" if mesh is not None else ""
                n_seeds = max(1, int(getattr(args, "seeds", 1)))
                ck, rs = restart_opts(args)
                if n_seeds > 1:
                    _run_seed_ensemble(cfg, dataset, args.device, n_seeds,
                                       missing, alpha, checkpoint_every=ck,
                                       resume=rs,
                                       early_stopping=early_stopper(
                                           args, cfg, ensemble=True),
                                       mesh=mesh, tag=tag)
                    continue
                print(f"=== train {cfg.vae_type} (MNAR, missing={missing}, "
                      f"alpha={alpha}){tag} ===", flush=True)
                t0 = time.perf_counter()
                params, device = None, args.device
                if mesh is not None:
                    # MNAR evaluation is one full-matrix pass a rep: it
                    # runs single-program on the gathered parameters
                    params, _ = train_sharded(
                        dataset, cfg, mesh, save=True, checkpoint_every=ck,
                        resume=rs, early_stopping=early_stopper(args, cfg))
                    device = mesh.device
                else:
                    train_engine.train(dataset, cfg,
                                       log_fn=epoch_logger(cfg.epoch),
                                       device=device, checkpoint_every=ck,
                                       resume=rs,
                                       early_stopping=early_stopper(args,
                                                                    cfg))
                t_train = time.perf_counter() - t0
                print(f"=== eval {cfg.vae_type} (MNAR) ===", flush=True)
                t0 = time.perf_counter()
                rmse = evaluate.eval_vae_mnar(
                    dataset.train.x, dataset.train.mask, cfg, params=params,
                    save=multihost.is_coordinator(), device=device)
                print(f"  rmse={rmse:.5f}")
                print(f"  [timing] train {t_train:.1f}s  "
                      f"eval {time.perf_counter() - t0:.1f}s", flush=True)


def _run_seed_ensemble(cfg: RunConfig, dataset, device, n_seeds: int,
                       missing, alpha, checkpoint_every=None, resume=False,
                       early_stopping=None, mesh=None, tag="") -> None:
    """`-seeds N`: this cell's N seed replicas trained as one seed ensemble
    (dp-sharded over `mesh` when given, the train line ending in `tag`),
    evaluated in one vmapped MNAR evaluation, mean±std printed. Seed 0
    keeps the reference checkpoint and artifact; seed s saves under
    `.seed{s}`; rank 0 alone writes."""
    print(f"=== train {cfg.vae_type} (MNAR, missing={missing}, "
          f"alpha={alpha}, seeds={n_seeds}){tag} ===", flush=True)
    t0 = time.perf_counter()
    path = checkpoint.checkpoint_path(cfg, "experiments")
    params_ens, _ = sweep.train_seed_ensemble(
        dataset, cfg, seeds=[cfg.seed + s for s in range(n_seeds)],
        checkpoint_every=checkpoint_every, resume=resume,
        resume_path=path + f".seeds{n_seeds}.resume.pt",
        early_stopping=early_stopping, device=device, mesh=mesh)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    params_host = checkpoint.on_device(params_ens, "cpu")
    writer = multihost.is_coordinator()
    if writer:
        checkpoint.save_many(
            [(sweep.ensemble_replica(params_host, s),
              path + checkpoint.seed_suffix(s)) for s in range(n_seeds)])
    rmses = evaluate.eval_vae_mnar_ensemble(
        dataset.train.x, dataset.train.mask, cfg, params_ens, save=writer,
        device=device)
    wait_for_writes(mesh)
    print(f"  rmse={rmses.mean():.5f}±{rmses.std():.5f}  "
          + " ".join(f"s{s}={v:.5f}" for s, v in enumerate(rmses)))
    print(f"  [timing] train {t_train:.1f}s  "
          f"eval+save {time.perf_counter() - t0:.1f}s", flush=True)


def _run_sweep_ensemble(record, argv, missings, alphas) -> None:
    """`-ensemble true`: this record's (missing x alpha x seed) product
    trained as one ensemble (row (mi * A + ai) * S + si holds missings[mi],
    alphas[ai], seed si), then evaluated in one vmapped MNAR evaluation a
    rate, under that rate's config. Vanilla records depend on neither knob
    in training nor in the MNAR imputation, so their axes collapse to the
    first cell. Checkpoints go to the reference names of each (alpha,
    rate) with `.seed{s}` siblings; each cell's seed-0 RMSE to its
    reference artifact."""
    args = setup_parser(record, "impute_eval").parse_args(argv)
    cfg = RunConfig.from_args(args, alpha=alphas[0],
                              p_missingness=missings[0],
                              data_transform=DATA_TRANSFORM,
                              not_miwae_type=NOT_MIWAE_TYPE)
    dataset = _load(cfg, args.device)
    mesh = resolve_mesh(cfg, device=args.device)
    tag = f" mesh={dict(mesh.shape)}" if mesh is not None else ""
    n_seeds = max(1, int(getattr(args, "seeds", 1)))
    seeds = [cfg.seed + s for s in range(n_seeds)] if n_seeds > 1 else None
    reg = cfg.info.regularized
    cfg_miss = list(missings) if reg else list(missings[:1])
    cfg_alphas = list(alphas) if reg else list(alphas[:1])
    note = "" if reg else " (vanilla: alpha/rate-free, one cell)"
    seed_tag = f", seeds={n_seeds}" if n_seeds > 1 else ""
    print(f"=== sweep-ensemble train {cfg.vae_type} (MNAR, "
          f"missings={cfg_miss}, alphas={cfg_alphas}{seed_tag}){tag}{note} "
          f"===", flush=True)
    ck, rs = restart_opts(args)
    t0 = time.perf_counter()
    params_ens, _, rows = sweep.train_sweep_ensemble(
        dataset, cfg, missings=cfg_miss, alphas=cfg_alphas, seeds=seeds,
        checkpoint_every=ck, resume=rs,
        resume_path=checkpoint.checkpoint_path(cfg, "experiments")
        + f".mnarsweep{len(cfg_miss) * len(cfg_alphas) * n_seeds}.resume.pt",
        early_stopping=early_stopper(args, cfg, ensemble=True),
        device=args.device, mesh=mesh)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    params_host = checkpoint.on_device(params_ens, "cpu")
    writer = multihost.is_coordinator()
    if writer:
        checkpoint.save_many(
            (sweep.ensemble_replica(params_host, ri),
             checkpoint.checkpoint_path(
                 cfg.replace(alpha=a, p_missingness=m), "experiments")
             + checkpoint.seed_suffix(0 if s is None else int(s) - cfg.seed))
            for ri, (m, a, s) in enumerate(rows))
    S = n_seeds
    for m in cfg_miss:
        ids = [ri for ri, (rm, _a, _s) in enumerate(rows) if rm == m]
        sub = sweep.ensemble_replica(params_host, ids)
        rmses = evaluate.eval_vae_mnar_ensemble(
            dataset.train.x, dataset.train.mask,
            cfg.replace(p_missingness=m), sub, save=False,
            device=args.device)
        for ai, a in enumerate(cfg_alphas):
            cell = np.asarray(rmses[ai * S:(ai + 1) * S])
            cfg_ma = cfg.replace(alpha=a, p_missingness=m)
            if writer:
                paths = artifacts.eval_mnar_paths(cfg_ma, "experiments")
                artifacts.save_tensor(float(cell[0]), paths["rmse"])
                artifacts.log_metric(cfg_ma, "rmse_mnar", float(cell[0]),
                                     "test", "experiments")
            line = (f"rmse={cell.mean():.5f}±{cell.std():.5f}  "
                    + " ".join(f"s{si}={v:.5f}"
                               for si, v in enumerate(cell))
                    if n_seeds > 1 else f"rmse={float(cell[0]):.5f}")
            print(f"  missing={m} alpha={a:g} {line}")
    wait_for_writes(mesh)
    print(f"  [timing] train {t_train:.1f}s  eval+save "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    try:
        records, probe = open_grid(GRID, argv)
        with multihost.coordinator_stdout(), maybe_profile(probe):
            run_grid(records, probe, argv)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except NotImplementedError as exc:
        sys.exit(f"imputation_mnar: {exc}")

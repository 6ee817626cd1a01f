"""MCAR imputation experiment: train and evaluate every record of
`Data/imputation_args.json` (port of the serial grid of the JAX package's
`experiment_main/imputation.py`; reference: src/experiment_main/
imputation.py:20-59).

    python -m vae_posterior_consistency_tpu_torch.experiment_main.imputation \
        [-<field> <value> ...] [-device cpu]

Run from the directory that holds `Data/` (the two default grids are
written into it first where they are missing, as the JAX package does:
`data/default_configs.write_default_configs`); checkpoints and artifacts
go to `experiments/` there. Each record is parsed with
`config.setup_parser`, so a CLI flag overrides that field in every record
(a `-vae_type` too: the reference's parse-per-record contract). For each
record and each (p_missingness, alpha) of the sweep (`-missings`,
`-alphas`; by default 30 and 1.0, as the reference hard-codes them) it
loads the data, trains with `engine/train.train`, saves the
reference-named checkpoint, evaluates with `engine/evaluate.eval_vae`,
which writes the artifacts, and prints each split's metrics.

The run uses the card (`-device cuda`, the default; it raises without CUDA)
or, with `-device cpu`, the kernels' plain versions on the CPU. Every
record of the grid runs: the gauss, flow, MIWAE and notMIWAE families, in
float32 or, for a record whose `compute_dtype` is 'bfloat16', with bf16
dense products (`models/registry.get_model`). `-checkpoint_every N`,
`-resume true` and `-early_stop true` (patience `-patience` checks, one
each 200 epochs) reach `train` as in the JAX package. `-profile DIR` traces the whole run with torch.profiler
(`config.maybe_profile`); VPC_DEBUG_NANS=1 turns on the NaN tripwire
(`utils/debugging.enable_nan_debugging`) and VPC_PLATFORM=cpu|cuda sets
the default of `-device` (`start_up`, which every entry point calls
first).

`-mesh` (`config.resolve_mesh`, per record, as the JAX package resolves
it): '' and a one-device 'auto' run the engines above; 'DP' or 'DP,TP'
train with `parallel/train_parallel.train_sharded` (rows dp-sharded, wide
leaves tp-sharded) and evaluate with `engine/evaluate_sharded.
eval_vae_sharded`, the train line tagged with the mesh, `mesh={'dp': 2,
'tp': 1}`. A mesh spans the ranks of the process group: run one process a
device with `torchrun --nproc_per_node N -m
vae_posterior_consistency_tpu_torch.experiment_main.imputation -mesh DP,TP`
(`open_grid` joins the group torchrun describes; a one-device mesh needs
no torchrun). Every rank runs the grid; only rank 0 prints and writes.
Beside `-seeds N` and `-ensemble true` the ensembles' replica rows are
dp-sharded over the mesh (`parallel/sweep`'s `mesh`), the banner or the
train line tagged ", mesh={...}" as in the JAX package; their evaluation
runs on the gathered parameters.

Ensembles (`parallel/sweep`; the JAX package's experiment_main/
imputation.py:63-79, 110-476, 487-513), with its banners, checkpoint names,
`.seed{s}` suffixes, resume-file names and artifact policy:
- `-seeds N` on the serial grid: each record's N seed replicas (seeds
  seed..seed+N-1) train as one seed ensemble and evaluate as one vmapped
  evaluation (`_train_and_eval_seeds`); seed 0 keeps the reference names,
  seed s saves under `.seed{s}`;
- `-ensemble true`: the grid groups records that differ only in the
  vae_type split digit and trains each group as one split ensemble
  (`run_suite_ensembles`; `-seeds` repeats the group), `-alphas a,b,...`
  each record's alpha sweep as one ensemble (`run_suite_alpha_ensembles`,
  with `-seeds` paired over alphas), `-missings m1,m2,...` each record's
  (missing x alpha x seed) product (`run_suite_sweep_ensembles`); a
  `-vae_type` flag cuts the grid to that record (`restrict_grid_records`).
Their streams are the ensembles' own, so their seed-0 files are
statistically equivalent to, not reproductions of, the serial run's.
"""

from __future__ import annotations

import json
import os
import sys
import time
import torch

from vae_posterior_consistency_tpu_torch.config import (
    RunConfig,
    device_count,
    early_stopper,
    iter_jsonl_configs,
    maybe_profile,
    mesh_shape,
    parse_alphas,
    parse_missings,
    resolve_mesh,
    restart_opts,
    restrict_grid_records,
    setup_parser,
)
from vae_posterior_consistency_tpu_torch.data import loaders
from vae_posterior_consistency_tpu_torch.data.default_configs import (
    write_default_configs,
)
from vae_posterior_consistency_tpu_torch.engine import checkpoint, evaluate
from vae_posterior_consistency_tpu_torch.engine import train as train_engine
from vae_posterior_consistency_tpu_torch.engine.evaluate_sharded import (
    eval_vae_sharded,
)
from vae_posterior_consistency_tpu_torch.parallel import multihost, sweep
from vae_posterior_consistency_tpu_torch.parallel.train_parallel import (
    train_sharded,
)
from vae_posterior_consistency_tpu_torch.utils.debugging import (
    apply_platform_from_env,
    enable_nan_debugging_from_env,
)
from vae_posterior_consistency_tpu_torch.utils.logging import epoch_logger

#: the grid, relative to the working directory
GRID = os.path.join("Data", "imputation_args.json")
#: hard-coded sweep axes, as the reference entry script has them
#: (src/experiment_main/imputation.py:23-24)
MISSING_SWEEP = [30]
ALPHA_SWEEP = [1.0]


def load_dataset(cfg: RunConfig, device):
    """The record's data: the prebuilt MNIST artifacts for data_type
    'mnist', else the UCI MCAR pipeline."""
    load = (loaders.data_loader_mnist if cfg.data_type == "mnist"
            else loaders.data_loader)
    return load(cfg.data_path, cfg.vae_type, cfg.missing_rate,
                cfg.batch_size, cfg.data_type, device=device)


def train_and_eval_one(dataset, cfg: RunConfig, device, checkpoint_every=None,
                       resume=False, early_stopping=None, mesh=None) -> dict:
    """Train `cfg` (the checkpoint saved under its reference name), then
    evaluate it and write its artifacts: on `mesh` with the sharded
    engines when one is given (as the JAX package's `_train_and_eval_one`,
    no epoch lines), else with the single-device ones."""
    if mesh is not None:
        train_sharded(dataset, cfg, mesh, save=True,
                      checkpoint_every=checkpoint_every, resume=resume,
                      early_stopping=early_stopping)
        print(f"=== eval {cfg.vae_type} ===", flush=True)
        return eval_vae_sharded(dataset, cfg, mesh)
    train_engine.train(dataset, cfg, log_fn=epoch_logger(
        cfg.epoch), device=device, checkpoint_every=checkpoint_every,
        resume=resume, early_stopping=early_stopping)
    print(f"=== eval {cfg.vae_type} ===", flush=True)
    return evaluate.eval_vae(dataset, cfg, device=device)


def _group_records(records):
    """Group config records into families that differ only in the vae_type
    split digit (reg_vae1/2/3 -> one group), in grid order."""
    groups, order = {}, []
    for rec in records:
        d = {k: v["default"] for k, v in rec.items()}
        key = ("".join(c for c in d["vae_type"] if not c.isdigit()),
               json.dumps({k: v for k, v in sorted(d.items())
                           if k != "vae_type"}))
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(rec)
    return [groups[k] for k in order]


def _mean_std(vals):
    mu = sum(vals) / len(vals)
    return mu, (sum((v - mu) ** 2 for v in vals) / len(vals)) ** 0.5


def _metrics_line(per_seed, stage, n_seeds) -> str:
    """One stage's metrics over the seeds: mean±std, or the value alone."""
    line = []
    for k in per_seed[0][stage]:
        mu, sd = _mean_std([ps[stage][k] for ps in per_seed])
        line.append(f"{k}={mu:.5f}±{sd:.5f}" if n_seeds > 1
                    else f"{k}={mu:.5f}")
    return "  ".join(line)


def wait_for_writes(mesh) -> None:
    """On a mesh, wait until rank 0 has written what this record writes."""
    if mesh is not None:
        multihost.barrier(mesh.device)


def _train_and_eval_seeds(dataset, cfg: RunConfig, device, n_seeds: int,
                          checkpoint_every=None, resume=False,
                          early_stopping=None, mesh=None) -> dict:
    """`-seeds N` on the serial grid: the N seed replicas of one config
    train as one seed ensemble (dp-sharded over `mesh` when given) and
    evaluate as one vmapped evaluation. Seed 0 keeps the reference
    checkpoint and artifact paths; the others save under `.seed{s}`; rank
    0 alone writes. Returns {stage: {metric: (mean, std)}}."""
    print("[seeds mode] seed replicas run as one vmapped program; PRNG "
          "streams differ from the plain serial run — seed-0 artifacts are "
          "statistically equivalent, not reproductions (PARITY.md deviation "
          "#8)", flush=True)
    seeds = [cfg.seed + si for si in range(n_seeds)]
    path = checkpoint.checkpoint_path(cfg, "experiments")
    params_ens, _hist = sweep.train_seed_ensemble(
        dataset, cfg, seeds, checkpoint_every=checkpoint_every, resume=resume,
        resume_path=path + f".seeds{n_seeds}.resume.pt",
        early_stopping=early_stopping, device=device, mesh=mesh)
    params_host = checkpoint.on_device(params_ens, "cpu")
    if multihost.is_coordinator():
        checkpoint.save_many(
            [(sweep.ensemble_replica(params_host, si),
              path + checkpoint.seed_suffix(si)) for si in range(n_seeds)])
    print(f"=== eval {cfg.vae_type} (seeds={n_seeds}) ===", flush=True)
    per_row = evaluate.eval_vae_ensemble(
        [dataset] * n_seeds, [cfg] * n_seeds, params_ens,
        save_rows=[0] if multihost.is_coordinator() else [], device=device)
    wait_for_writes(mesh)
    return {stage: {k: _mean_std([r[stage][k] for r in per_row])
                    for k in per_row[0][stage]}
            for stage in per_row[0]}


def run_suite_alpha_ensembles(records, argv, missing, alphas, n_seeds=1):
    """`-ensemble true -alphas a,b,...`: each record's alpha sweep trains as
    one ensemble (`sweep.train_alpha_ensemble`; with `-seeds`,
    `train_alpha_seed_ensemble`, rows of one seed paired across alphas).
    Vanilla records ignore alpha, so they train once at alphas[0]. Each
    (alpha, seed) row is saved under its reference name (alpha is in the
    regularized names) and evaluated serially, alpha entering the
    evaluation's arithmetic."""
    printed = False
    for rec in records:
        args = setup_parser(rec, "impute_eval").parse_args(argv)
        cfg = RunConfig.from_args(args, alpha=alphas[0],
                                  p_missingness=missing)
        mesh = resolve_mesh(cfg, device=args.device)
        if not printed:
            print("[alpha-ensemble mode] each config's alpha sweep runs as "
                  f"one vmapped program{_mesh_tag(mesh)}; replicas share "
                  "data/mask streams by design (isolates alpha)", flush=True)
            printed = True
        dataset = load_dataset(cfg, args.device)
        cfg_alphas = list(alphas) if cfg.info.regularized else alphas[:1]
        note = "" if cfg.info.regularized else " (vanilla: alpha-free, once)"
        seed_tag = f", seeds={n_seeds}" if n_seeds > 1 else ""
        print(f"=== alpha-ensemble train {cfg.vae_type} (missing={missing}, "
              f"alphas={cfg_alphas}{seed_tag}){note} ===", flush=True)
        t0 = time.perf_counter()
        ck, rs = restart_opts(args)
        rp = (checkpoint.checkpoint_path(cfg, "experiments")
              + f".alphas{len(cfg_alphas)}x{n_seeds}.resume.pt")
        common = dict(checkpoint_every=ck, resume=rs, resume_path=rp,
                      early_stopping=early_stopper(args, cfg, ensemble=True),
                      device=args.device, mesh=mesh)
        if n_seeds > 1:
            seeds = [cfg.seed + si for si in range(n_seeds)]
            params_ens, _ = sweep.train_alpha_seed_ensemble(
                dataset, cfg, cfg_alphas, seeds, **common)
        else:
            params_ens, _ = sweep.train_alpha_ensemble(
                dataset, cfg, cfg_alphas, seed=cfg.seed, **common)
        t_train = time.perf_counter() - t0
        t0 = time.perf_counter()
        params_host = checkpoint.on_device(params_ens, "cpu")
        writer = multihost.is_coordinator()
        if writer:
            checkpoint.save_many([
                (sweep.ensemble_replica(params_host, i * n_seeds + si),
                 checkpoint.checkpoint_path(cfg.replace(alpha=a),
                                            "experiments")
                 + checkpoint.seed_suffix(si))
                for i, a in enumerate(cfg_alphas) for si in range(n_seeds)])
        for i, a in enumerate(cfg_alphas):
            cfg_a = cfg.replace(alpha=a)
            per_seed = [evaluate.eval_vae(
                dataset, cfg_a,
                params=sweep.ensemble_replica(params_host, i * n_seeds + si),
                save=si == 0 and writer, device=args.device)
                for si in range(n_seeds)]
            for stage in per_seed[0]:
                print(f"  alpha={a:g} [{stage}] "
                      + _metrics_line(per_seed, stage, n_seeds), flush=True)
        wait_for_writes(mesh)
        print(f"  [timing] train {t_train:.1f}s  eval+save "
              f"{time.perf_counter() - t0:.1f}s", flush=True)


def run_suite_sweep_ensembles(records, argv, missings, alphas, n_seeds=1):
    """`-ensemble true -missings m1,m2[,...]`: each record's (missing rate x
    alpha x seed) product trains as one ensemble
    (`sweep.train_sweep_ensemble`). Vanilla training depends on neither
    knob, so a vanilla record trains once a seed and is evaluated at every
    rate (the evaluation's mask_p draw depends on it and the artifacts are
    named per (alpha, missing))."""
    printed = False
    for rec in records:
        args = setup_parser(rec, "impute_eval").parse_args(argv)
        cfg = RunConfig.from_args(args, alpha=alphas[0],
                                  p_missingness=missings[0])
        mesh = resolve_mesh(cfg, device=args.device)
        if not printed:
            print("[sweep-ensemble mode] each config's (missing x alpha"
                  f" x seed) product runs as one vmapped program"
                  f"{_mesh_tag(mesh)}; rows share data/shuffle streams by "
                  "design (pairs the swept knobs)", flush=True)
            printed = True
        dataset = load_dataset(cfg, args.device)
        reg = cfg.info.regularized
        cfg_alphas = list(alphas) if reg else alphas[:1]
        cfg_miss = list(missings) if reg else missings[:1]
        note = "" if reg else " (vanilla: rate/alpha-free training, once)"
        seeds = ([cfg.seed + si for si in range(n_seeds)]
                 if n_seeds > 1 else None)
        seed_tag = f", seeds={n_seeds}" if n_seeds > 1 else ""
        print(f"=== sweep-ensemble train {cfg.vae_type} "
              f"(missings={cfg_miss}, alphas={cfg_alphas}{seed_tag})"
              f"{note} ===", flush=True)
        t0 = time.perf_counter()
        ck, rs = restart_opts(args)
        params_ens, _, rows = sweep.train_sweep_ensemble(
            dataset, cfg, missings=cfg_miss, alphas=cfg_alphas, seeds=seeds,
            checkpoint_every=ck, resume=rs,
            resume_path=checkpoint.checkpoint_path(cfg, "experiments")
            + f".sweep{len(cfg_miss) * len(cfg_alphas) * n_seeds}"
            ".resume.pt",
            early_stopping=early_stopper(args, cfg, ensemble=True),
            device=args.device, mesh=mesh)
        t_train = time.perf_counter() - t0
        t0 = time.perf_counter()
        params_host = checkpoint.on_device(params_ens, "cpu")
        # the rows of each (missing, alpha) cell, computed once for both the
        # checkpoint and the evaluation passes
        groups = []
        for mi, m in enumerate(missings):
            for a in cfg_alphas:
                m_trained = m if reg else cfg_miss[0]
                row_ids = [ri for ri, (rm, ra, _) in enumerate(rows)
                           if rm == m_trained and ra == a]
                groups.append((m, a, mi, row_ids,
                               cfg.replace(alpha=a, p_missingness=m)))
        # one checkpoint a trained row (vanilla names hold no rate)
        writer = multihost.is_coordinator()
        if writer:
            checkpoint.save_many(
                (sweep.ensemble_replica(params_host, ri),
                 checkpoint.checkpoint_path(cfg_ma, "experiments")
                 + checkpoint.seed_suffix(si))
                for m, a, mi, row_ids, cfg_ma in groups
                if reg or mi == 0
                for si, ri in enumerate(row_ids))
        for m, a, mi, row_ids, cfg_ma in groups:
            per_seed = [evaluate.eval_vae(
                dataset, cfg_ma, params=sweep.ensemble_replica(params_host,
                                                               ri),
                save=si == 0 and writer, device=args.device)
                for si, ri in enumerate(row_ids)]
            for stage in per_seed[0]:
                print(f"  missing={m} alpha={a:g} [{stage}] "
                      + _metrics_line(per_seed, stage, n_seeds), flush=True)
        wait_for_writes(mesh)
        print(f"  [timing] train {t_train:.1f}s  eval+save "
              f"{time.perf_counter() - t0:.1f}s", flush=True)


def run_suite_ensembles(records, argv, missing, alpha):
    """`-ensemble true`: each family's split group trains as one split
    ensemble (`sweep.train_split_ensemble`, `-seeds` repeating the group),
    saves a checkpoint a row (seed s of split i at row s * n_splits + i,
    `.seed{s}` for s > 0), and evaluates as one vmapped evaluation a
    split-size class, the seed-0 rows writing the artifacts."""
    printed_banner = False
    for group in _group_records(records):
        args = setup_parser(group[0], "impute_eval").parse_args(argv)
        cfgs = [RunConfig.from_args(args, vae_type=rec["vae_type"]["default"],
                                    alpha=alpha, p_missingness=missing)
                for rec in group]
        mesh = resolve_mesh(cfgs[0], device=args.device)
        if not printed_banner:
            print("[ensemble mode] grid runs as vmapped split-ensembles"
                  f"{_mesh_tag(mesh)}; PRNG streams differ from the serial "
                  "path (PARITY.md deviation #8)", flush=True)
            printed_banner = True
        datasets = [load_dataset(c, args.device) for c in cfgs]
        names = [c.vae_type for c in cfgs]
        n_seeds = max(1, int(getattr(args, "seeds", 1)))
        seed_tag = f", seeds={n_seeds}" if n_seeds > 1 else ""
        print(f"=== ensemble train {names} (missing={missing}, "
              f"alpha={alpha}{seed_tag}) ===", flush=True)
        t0 = time.perf_counter()
        ck, rs = restart_opts(args)
        params_ens, _ = sweep.train_split_ensemble(
            datasets, cfgs[0], n_seeds=n_seeds, checkpoint_every=ck,
            resume=rs,
            resume_path=checkpoint.checkpoint_path(cfgs[0], "experiments")
            + f".ens{len(cfgs) * n_seeds}.resume.pt",
            early_stopping=early_stopper(args, cfgs[0], ensemble=True),
            device=args.device, mesh=mesh)
        t_train = time.perf_counter() - t0
        t0 = time.perf_counter()
        S0 = len(cfgs)
        params_host = checkpoint.on_device(params_ens, "cpu")
        writer = multihost.is_coordinator()
        if writer:
            checkpoint.save_many([
                (sweep.ensemble_replica(params_host, row),
                 checkpoint.checkpoint_path(cfgs[row % S0], "experiments")
                 + checkpoint.seed_suffix(row // S0))
                for row in range(S0 * n_seeds)])
        t_save = time.perf_counter() - t0
        # one vmapped evaluation a split-size class; the seed-0 rows keep
        # the reference artifacts (eval_vae_ensemble's save_rows)
        all_datasets, all_cfgs = datasets * n_seeds, cfgs * n_seeds
        classes: dict = {}
        for r in range(S0 * n_seeds):
            d = all_datasets[r]
            classes.setdefault((d.train.n, None if d.test is None
                                else d.test.n), []).append(r)
        all_results = [None] * (S0 * n_seeds)
        for rows_cls in classes.values():
            res = evaluate.eval_vae_ensemble(
                [all_datasets[r] for r in rows_cls],
                [all_cfgs[r] for r in rows_cls],
                sweep.ensemble_replica(params_ens, rows_cls),
                save_rows=[j for j, r in enumerate(rows_cls)
                           if r < S0 and writer],
                device=args.device)
            for j, r in enumerate(rows_cls):
                all_results[r] = res[j]
        for i, cfg in enumerate(cfgs):
            per_seed = [all_results[s * S0 + i] for s in range(n_seeds)]
            for stage in per_seed[0]:
                print(f"  {cfg.vae_type} [{stage}] "
                      + _metrics_line(per_seed, stage, n_seeds), flush=True)
        wait_for_writes(mesh)
        t_eval = time.perf_counter() - t0
        print(f"  [timing] train {t_train:.1f}s  eval+save {t_eval:.1f}s  "
              f"(save={t_save:.1f}s eval={t_eval - t_save:.1f}s)",
              flush=True)


def run_ensembles(records, probe, argv) -> None:
    """The `-ensemble true` dispatch (the JAX package's `_run_grid`):
    `-missings` with more than one rate, else `-alphas` with more than one
    value, else the split ensembles."""
    records = restrict_grid_records(records, probe)
    alphas = parse_alphas(probe, ALPHA_SWEEP)
    missings = parse_missings(probe, MISSING_SWEEP)
    n_seeds = max(1, int(getattr(probe, "seeds", 1)))
    if len(missings) > 1:
        run_suite_sweep_ensembles(records, argv, missings, alphas,
                                  n_seeds=n_seeds)
    elif len(alphas) > 1:
        for missing in missings:
            run_suite_alpha_ensembles(records, argv, missing, alphas,
                                      n_seeds=n_seeds)
    else:
        for missing in missings:
            for alpha in alphas:
                run_suite_ensembles(records, argv, missing, alpha)


def run_grid(records, probe, argv) -> None:
    """The serial grid (each record's `-seeds N` replicas as one seed
    ensemble)."""
    alphas = parse_alphas(probe, ALPHA_SWEEP)
    missings = parse_missings(probe, MISSING_SWEEP)
    n_seeds = max(1, int(getattr(probe, "seeds", 1)))
    for record in records:
        for missing in missings:
            for alpha in alphas:
                args = setup_parser(record, "impute_eval").parse_args(argv)
                cfg = RunConfig.from_args(args, alpha=alpha,
                                          p_missingness=missing)
                dataset = load_dataset(cfg, args.device)
                mesh = resolve_mesh(cfg, device=args.device)
                tag = f" mesh={dict(mesh.shape)}" if mesh is not None else ""
                seed_tag = f", seeds={n_seeds}" if n_seeds > 1 else ""
                print(f"=== train {cfg.vae_type} (missing={missing}, "
                      f"alpha={alpha}{seed_tag}){tag} ===", flush=True)
                ck, rs = restart_opts(args)
                if n_seeds > 1:
                    results = _train_and_eval_seeds(
                        dataset, cfg, args.device, n_seeds,
                        checkpoint_every=ck, resume=rs,
                        early_stopping=early_stopper(args, cfg,
                                                     ensemble=True),
                        mesh=mesh)
                    for stage, metrics in results.items():
                        print(f"  [{stage}] " + "  ".join(
                            f"{k}={mu:.5f}±{sd:.5f}"
                            for k, (mu, sd) in metrics.items()), flush=True)
                    continue
                results = train_and_eval_one(
                    dataset, cfg, args.device, checkpoint_every=ck, resume=rs,
                    early_stopping=early_stopper(args, cfg), mesh=mesh)
                for stage, metrics in results.items():
                    print(f"  [{stage}] " + "  ".join(
                        f"{k}={v:.5f}" for k, v in metrics.items()),
                        flush=True)


def start_up() -> None:
    """What every entry point does first, as the JAX package's do: the
    environment switches (VPC_PLATFORM, VPC_DEBUG_NANS) and the default
    grids written into `Data/` where they are missing."""
    apply_platform_from_env()
    enable_nan_debugging_from_env()
    write_default_configs("Data")


def _mesh_tag(mesh) -> str:
    """The ensemble banners' mesh tag, as the JAX package prints it."""
    return f", mesh={dict(mesh.shape)}" if mesh is not None else ""


def open_grid(grid: str, argv):
    """`start_up`, then the records of the JSONL `grid` and the parse of
    `argv` against the first; under torchrun the process group is joined
    (`multihost.initialize`, on the `-device` parsed); a `-mesh` no device
    count satisfies is refused (`mesh_shape`'s ValueError), and the device is
    checked and printed (by rank 0) before anything runs."""
    start_up()
    records = list(iter_jsonl_configs(grid))
    probe = setup_parser(records[0], "impute_eval").parse_args(argv)
    multihost.initialize(probe.device)
    mesh_shape(probe.mesh, device_count())
    device = train_engine.check_device(probe.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "the kernels' plain versions")
    with multihost.coordinator_stdout():
        print(f"Device: {device} ({name})", flush=True)
    return records, probe


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    try:
        records, probe = open_grid(GRID, argv)
        with multihost.coordinator_stdout(), maybe_profile(probe):
            if probe.ensemble:
                run_ensembles(records, probe, argv)
            else:
                run_grid(records, probe, argv)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except NotImplementedError as exc:
        sys.exit(f"imputation: {exc}")

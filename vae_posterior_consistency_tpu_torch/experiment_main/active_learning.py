"""Active variable selection over every record of `Data/imputation_args.json`
(port of the JAX package's `experiment_main/active_learning.py`; reference:
src/experiment_main/active_learning.py:23-74).

    python -m \\
        vae_posterior_consistency_tpu_torch.experiment_main.active_learning \\
        [-<field> <value> ...] [-ensemble true] [-seeds N] [-device cpu]

Run from the directory that holds `Data/` and the `experiments/` tree that
`experiment_main/imputation.py` trained there: the episodes use each
record's trained checkpoint (the reference does not train here either) and
stop with its path where one is missing. Each record is parsed with
`config.setup_parser`, so a CLI flag overrides that field in every record.
For each record and each (p_missingness, alpha) of the sweep (`-missings`,
`-alphas`; by default 30 and 1.0, as the reference hard-codes them) it
loads the data (`data_loader`), runs one selection episode on the test
rows (`engine/active_learning.active_learning_func`), which writes the four
artifacts and the `al_final_mse` metric, and prints the information curve
and the episode's wall-clock.

Ensembles (the JAX package's experiment_main/active_learning.py:117-232),
through `engine/active_learning.active_learning_ensemble`, one vmapped
episode for all replicas:
- `-seeds N`: each cell's N seed-replica checkpoints (checkpoint.pt and its
  `.seed{s}` siblings, written by `imputation -seeds N` or `-ensemble true
  -seeds N`) in one episode (`_run_seed_ensemble`);
- `-ensemble true`: the grid cut by `-vae_type` to its record
  (`restrict_grid_records`), each record's (alpha x seed) replicas in one
  episode a missing rate (`_run_sweep_ensemble`).

The run uses the card (`-device cuda`, the default; it raises without CUDA)
or, with `-device cpu`, the kernels' plain versions on the CPU. A record
whose `compute_dtype` is 'bfloat16' narrows the episode's `completion`
(its `eval_step`) and keeps the rewards' encoder calls in float32, as the
JAX package does. `-mesh` resolves per record
(`config.resolve_mesh`): on a mesh every path's test rows are dp-sharded
(`engine/active_learning`'s `mesh`), its line tagged with it, and rank 0
alone prints and writes (run one process a device under torchrun, as
`experiment_main/imputation`); `-profile DIR` traces the run, with the
program's own spans (`utils/tracing`).
`-checkpoint_every`, `-resume` and `-early_stop` are accepted and ignored,
as in the JAX package: nothing trains here.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from vae_posterior_consistency_tpu_torch.config import (
    RunConfig,
    maybe_profile,
    parse_alphas,
    parse_missings,
    resolve_mesh,
    restrict_grid_records,
    setup_parser,
)
from vae_posterior_consistency_tpu_torch.data import loaders
from vae_posterior_consistency_tpu_torch.engine import (
    active_learning,
    artifacts,
    checkpoint,
)
from vae_posterior_consistency_tpu_torch.experiment_main.imputation import (
    open_grid,
    wait_for_writes,
)
from vae_posterior_consistency_tpu_torch.parallel import multihost

#: the grid, relative to the working directory
GRID = os.path.join("Data", "imputation_args.json")
#: hard-coded sweep axes (reference: src/experiment_main/active_learning.py)
MISSING_SWEEP = [30]
ALPHA_SWEEP = [1.0]


def _load(cfg: RunConfig, device):
    return loaders.data_loader(cfg.data_path, cfg.vae_type, cfg.missing_rate,
                               cfg.batch_size, cfg.data_type, device=device)


def run_grid(records, probe, argv) -> None:
    """The grid: one episode a record x missing x alpha (each cell's
    `-seeds N` replicas as one ensemble episode), or with `-ensemble true`
    one ensemble episode a record and missing rate."""
    alphas = parse_alphas(probe, ALPHA_SWEEP)
    missings = parse_missings(probe, MISSING_SWEEP)
    ensemble = bool(probe.ensemble)
    if ensemble:
        records = restrict_grid_records(records, probe)
    for record in records:
        if ensemble:
            _run_sweep_ensemble(record, argv, missings, alphas)
            continue
        for missing in missings:
            for alpha in alphas:
                args = setup_parser(record, "impute_eval").parse_args(argv)
                cfg = RunConfig.from_args(args, alpha=alpha,
                                          p_missingness=missing)
                ds = _load(cfg, args.device)
                mesh = resolve_mesh(cfg, device=args.device)
                tag = f" mesh={dict(mesh.shape)}" if mesh is not None else ""
                n_seeds = max(1, int(args.seeds))
                if n_seeds > 1:
                    _run_seed_ensemble(cfg, ds, n_seeds, args.device, mesh,
                                       tag)
                    continue
                print(f"=== active learning {cfg.vae_type}{tag} ===",
                      flush=True)
                t0 = time.perf_counter()
                out = active_learning.active_learning_func(
                    None, ds.test.x, ds.test.mask, cfg, Repeat=1,
                    mesh=mesh, device=args.device)
                wait_for_writes(mesh)
                curve = out["information_curve"][0, 0, :].tolist()
                print("  info curve (target MSE per #revealed): "
                      + " ".join(f"{v:.4f}" for v in curve))
                print(f"  [timing] episode {time.perf_counter() - t0:.1f}s",
                      flush=True)


def _run_seed_ensemble(cfg: RunConfig, ds, n_seeds: int, device, mesh=None,
                       tag: str = "") -> None:
    """`-seeds N`: the cell's N seed-replica checkpoints in one episode
    (its test rows dp-sharded over `mesh` when given, the line ending in
    `tag`), the final target MSE of each seed printed with their mean±std.
    FileNotFoundError names a seed checkpoint that was never trained."""
    print(f"=== active learning {cfg.vae_type} (seeds={n_seeds}){tag} ===",
          flush=True)
    params_ens = checkpoint.load_seed_ensemble(cfg, ds.obs_dim, n_seeds,
                                               device=device)
    t0 = time.perf_counter()
    out = active_learning.active_learning_ensemble(
        ds.test.x, ds.test.mask, cfg, params_ens, Repeat=1, mesh=mesh,
        device=device)
    wait_for_writes(mesh)
    curves = out["information_curve"][:, 0, 0, :].cpu().numpy()
    finals = curves[:, -1]
    print(f"  final target-MSE={finals.mean():.5f}±{finals.std():.5f}  "
          + " ".join(f"s{s}={v:.5f}" for s, v in enumerate(finals)))
    print("  seed-0 info curve: " + " ".join(f"{v:.4f}" for v in curves[0]))
    print(f"  [timing] {n_seeds}-seed episode "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def _run_sweep_ensemble(record, argv, missings, alphas) -> None:
    """`-ensemble true`: the record's (alpha x seed) replicas, alpha-major
    and seed-minor (row ai * n_seeds + si), in one episode a missing rate,
    unsaved, then each cell saved as the JAX package saves it. Neither knob
    enters the episode: a replica differs only by the checkpoint it loads,
    whose name carries alpha and p_missingness for a regularized record.
    A vanilla record's checkpoint is alpha-free, so its alpha axis is one
    cell, and its artifact names carry neither knob, so with more than one
    rate only the first rate's are written (every rate's line is printed).
    A regularized cell saves at its own names, `.seed{s}` for seed s; one
    al_final_mse a cell, its seed 0's."""
    args = setup_parser(record, "impute_eval").parse_args(argv)
    cfg0 = RunConfig.from_args(args, alpha=alphas[0],
                               p_missingness=missings[0])
    ds = _load(cfg0, args.device)
    mesh = resolve_mesh(cfg0, device=args.device)
    tag = f" mesh={dict(mesh.shape)}" if mesh is not None else ""
    n_seeds = max(1, int(args.seeds))
    reg = cfg0.info.regularized
    cfg_alphas = list(alphas) if reg else list(alphas[:1])
    note = "" if reg else " (vanilla: alpha-free checkpoints, one cell)"
    seed_tag = f", seeds={n_seeds}" if n_seeds > 1 else ""
    print(f"=== active learning {cfg0.vae_type} (ensemble, "
          f"missings={list(missings)}, alphas={cfg_alphas}{seed_tag})"
          f"{tag}{note} ===", flush=True)
    for mi, m in enumerate(missings):
        parts = [checkpoint.flatten(checkpoint.load_seed_ensemble(
            cfg0.replace(alpha=a, p_missingness=m), ds.obs_dim, n_seeds,
            device=args.device)) for a in cfg_alphas]
        params_ens = checkpoint.unflatten(
            {k: torch.cat([p[k] for p in parts]) for k in parts[0]})
        t0 = time.perf_counter()
        out = active_learning.active_learning_ensemble(
            ds.test.x, ds.test.mask, cfg0.replace(p_missingness=m),
            params_ens, Repeat=1, save=False, mesh=mesh, device=args.device)
        host = {k: v.cpu() for k, v in out.items()}
        for ai, a in enumerate(cfg_alphas):
            cfg_ma = cfg0.replace(alpha=a, p_missingness=m)
            finals = host["information_curve"][
                ai * n_seeds:(ai + 1) * n_seeds, 0, 0, -1].numpy()
            line = (f"final target-MSE={finals.mean():.5f}"
                    f"±{finals.std():.5f}  "
                    + " ".join(f"s{si}={v:.5f}"
                               for si, v in enumerate(finals))
                    if n_seeds > 1
                    else f"final target-MSE={float(finals[0]):.5f}")
            print(f"  missing={m} alpha={a:g} {line}")
            if (reg or mi == 0) and multihost.is_coordinator():
                paths = artifacts.active_learning_paths(cfg_ma, "experiments")
                for si in range(n_seeds):
                    r = ai * n_seeds + si
                    for name in active_learning.ARTIFACTS:
                        artifacts.save_tensor(
                            host[name][r].contiguous(),
                            paths[name] + checkpoint.seed_suffix(si))
                artifacts.log_metric(
                    cfg_ma, "al_final_mse",
                    host["information_curve"][ai * n_seeds, :, 0,
                                              -1].numpy(),
                    "test", "experiments")
        wait_for_writes(mesh)
        print(f"  [timing] missing={m} "
              f"{len(cfg_alphas) * n_seeds}-replica episode "
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
        sys.exit(f"active_learning: {exc}")

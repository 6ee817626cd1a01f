"""MCAR imputation experiment: train and evaluate every record of
`Data/imputation_args.json` (port of the serial grid of the JAX package's
`experiment_main/imputation.py`; reference: src/experiment_main/
imputation.py:20-59).

    python -m vae_posterior_consistency_tpu_torch.experiment_main.imputation \
        [-<field> <value> ...] [-device cpu]

Run from the directory that holds `Data/`; checkpoints and artifacts go to
`experiments/` there. Each record is parsed with `config.setup_parser`, so a
CLI flag overrides that field in every record (a `-vae_type` too: the
reference's parse-per-record contract). For each record and each
(p_missingness, alpha) of the sweep (`-missings`, `-alphas`; by default 30
and 1.0, as the reference hard-codes them) it loads the data, trains with
`engine/train.train`, saves the reference-named checkpoint, evaluates with
`engine/evaluate.eval_vae`, which writes the artifacts, and prints each
split's metrics.

The run uses the card (`-device cuda`, the default; it raises without CUDA)
or, with `-device cpu`, the kernels' plain versions on the CPU. Every
record of the grid runs: the gauss, flow, MIWAE and notMIWAE families. A
record the port cannot run yet (one whose `compute_dtype` is 'bfloat16')
is not run: one line names it and the slice that brings it, and the run
goes on; the exit code is then 1 and the end of the output lists those
records. `-checkpoint_every N`, `-resume true` and `-early_stop true`
(patience `-patience` checks, one each 200 epochs) reach `train` as in the
JAX package. Flags whose engine the port lacks (`-mesh`, `-ensemble`,
`-seeds` above 1, `-profile`) stop the run before it starts, naming their
slice.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import torch

from vae_posterior_consistency_tpu_torch.config import (
    RunConfig,
    check_unported,
    early_stopper,
    iter_jsonl_configs,
    parse_alphas,
    parse_missings,
    restart_opts,
    setup_parser,
)
from vae_posterior_consistency_tpu_torch.data import loaders
from vae_posterior_consistency_tpu_torch.engine import evaluate
from vae_posterior_consistency_tpu_torch.engine import train as train_engine
from vae_posterior_consistency_tpu_torch.models import get_model

#: the grid, relative to the working directory
GRID = os.path.join("Data", "imputation_args.json")
#: hard-coded sweep axes, as the reference entry script has them
#: (src/experiment_main/imputation.py:23-24)
MISSING_SWEEP = [30]
ALPHA_SWEEP = [1.0]


def unported(cfg: RunConfig) -> Optional[str]:
    """Why the port cannot run `cfg` yet (naming the slice), or None."""
    try:
        get_model(cfg)
    except NotImplementedError as exc:
        return str(exc)
    return None


def load_dataset(cfg: RunConfig, device):
    """The record's data: the prebuilt MNIST artifacts for data_type
    'mnist', else the UCI MCAR pipeline."""
    load = (loaders.data_loader_mnist if cfg.data_type == "mnist"
            else loaders.data_loader)
    return load(cfg.data_path, cfg.vae_type, cfg.missing_rate,
                cfg.batch_size, cfg.data_type, device=device)


def train_and_eval_one(dataset, cfg: RunConfig, device, checkpoint_every=None,
                       resume=False, early_stopping=None) -> dict:
    """Train `cfg` (the checkpoint saved under its reference name), then
    evaluate it and write its artifacts."""
    train_engine.train(dataset, cfg, log_fn=train_engine.epoch_logger(
        cfg.epoch), device=device, checkpoint_every=checkpoint_every,
        resume=resume, early_stopping=early_stopping)
    print(f"=== eval {cfg.vae_type} ===", flush=True)
    return evaluate.eval_vae(dataset, cfg, device=device)


def run_grid(records, probe, argv) -> list:
    """The serial grid; returns the runs not made, as (vae_type, missing,
    alpha, reason)."""
    alphas = parse_alphas(probe, ALPHA_SWEEP)
    missings = parse_missings(probe, MISSING_SWEEP)
    not_run = []
    for record in records:
        for missing in missings:
            for alpha in alphas:
                args = setup_parser(record, "impute_eval").parse_args(argv)
                cfg = RunConfig.from_args(args, alpha=alpha,
                                          p_missingness=missing)
                tag = f"{cfg.vae_type} (missing={missing}, alpha={alpha})"
                reason = unported(cfg)
                if reason is not None:
                    print(f"=== not run: {tag}: {reason} ===", flush=True)
                    not_run.append((cfg.vae_type, missing, alpha, reason))
                    continue
                dataset = load_dataset(cfg, args.device)
                print(f"=== train {tag} ===", flush=True)
                ck, rs = restart_opts(args)
                results = train_and_eval_one(
                    dataset, cfg, args.device, checkpoint_every=ck, resume=rs,
                    early_stopping=early_stopper(args, cfg))
                for stage, metrics in results.items():
                    print(f"  [{stage}] " + "  ".join(
                        f"{k}={v:.5f}" for k, v in metrics.items()),
                        flush=True)
    return not_run


def open_grid(grid: str, argv):
    """The records of the JSONL `grid` and the parse of `argv` against the
    first; flags whose engine the port lacks are refused and the device is
    checked and printed before anything runs."""
    if not os.path.isfile(grid):
        raise FileNotFoundError(
            f"{os.path.abspath(grid)} not found: run from the directory that "
            f"holds {grid}")
    records = list(iter_jsonl_configs(grid))
    probe = setup_parser(records[0], "impute_eval").parse_args(argv)
    check_unported(probe)
    device = train_engine.check_device(probe.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "the kernels' plain versions")
    print(f"Device: {device} ({name})", flush=True)
    return records, probe


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    records, probe = open_grid(GRID, argv)
    not_run = run_grid(records, probe, argv)
    if not_run:
        print(f"{len(not_run)} run(s) not made, not ported yet:",
              flush=True)
        for vae_type, missing, alpha, reason in not_run:
            print(f"  {vae_type} (missing={missing}, alpha={alpha}): "
                  f"{reason}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except NotImplementedError as exc:
        sys.exit(f"imputation: {exc}")

"""Full-budget statistical parity of the port against the JAX package: a
`vae_type` (the flagship `reg_vae1` by default; also `reg_flow1`,
`vanilla_flow1`, `vanilla_MIWAE1`, `reg_MIWAE1`, `reg_notMIWAE1`, ...) with
`kl_reg` on Data/wine split 1, trained and evaluated as
`tools/parity_check.py` does for the JAX row. An MCAR row runs as `run_ours`
ran it (3000 epochs, batch 64, missing_rate 30, M=2, alpha 1.0,
p_missingness 30, seeds 0-3; for the MIWAE rows train_k 10 and valid_k 50,
tools/parity_check.py:488-490; the other fields at their `RunConfig`
defaults), its score the test split's RMSE of `eval_vae`. The notMIWAE row
is an MNAR run, as `run_ours_mnar` ran it (tools/parity_check.py:325-343):
`data_loader_mnar` on the permuted table, missing_rate 50, p_missingness
50, M=2, alpha 1.0, train_k 10, valid_k 50, `not_miwae_type` 'changed',
`reg_notmiwae_variant` 'v2'; its score, the "test RMSE" of the JAX row, is
`eval_vae_mnar`'s full-matrix RMSE.

    python -m vae_posterior_consistency_tpu_torch.engine.parity_full_budget \
        [--vae_type reg_vae1] [--epochs 3000] [--seeds 4] [--device cuda] \
        [--out FILE]

Run from the root of a checkout. The JAX row is read as data from
`tools/parity_full_budget.jsonl` (the record of this configuration; its
"ours" fields are the JAX package's). The verdict is PARITY.md's formula,
with the 3% band of the full-budget rows:

    |port_mean - jax_mean| <= 3 * (sigma_jax + sigma_port) + 0.03 * |jax_mean|

on the test RMSE over the seeds (sigma the population std, as
tools/parity_check.py computes it). It prints each seed's metrics and
wall-clock, the means, the tolerance, the verdict and the card's name and
power limit, and as its last line one JSON object of all of them (also
written to `--out`). The exit code is 0 for PARITY OK, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.data import loaders
from vae_posterior_consistency_tpu_torch.engine import evaluate, train
from vae_posterior_consistency_tpu_torch.models import get_model

REPO = Path(__file__).resolve().parents[2]
JAX_ROWS = REPO / "tools" / "parity_full_budget.jsonl"
#: the configuration of the JAX rows (tools/parity_check.py:run_ours),
#: all but the vae_type
CONFIG = dict(reg_type="kl_reg", data_type="wine", batch_size=64,
              missing_rate=30, M=2, alpha=1.0, p_missingness=30)
#: the importance samples of the MIWAE and notMIWAE rows
#: (tools/parity_check.py:488-490)
IW_SAMPLES = dict(train_k=10, valid_k=50)
#: the MNAR row's configuration (tools/parity_check.py:run_ours_mnar), all
#: but the vae_type
MNAR_CONFIG = dict(reg_type="kl_reg", data_type="wine", batch_size=64,
                   missing_rate=50, M=2, alpha=1.0, p_missingness=50,
                   **IW_SAMPLES, not_miwae_type="changed",
                   reg_notmiwae_variant="v2")
#: the missing_rate the JSONL gives the MNAR row: the recorder's
#: --missing_rate default, not the 50 that run_ours_mnar runs at
MNAR_ROW_MISSING_RATE = 30
BAND = 0.03
METRICS = ("rmse", "loss", "negl", "negl_imp")


def is_mnar(config: dict) -> bool:
    return get_model(RunConfig(vae_type=config["vae_type"])).name == "notmiwae"


def jax_row(config: dict) -> dict:
    """The JAX package's full-budget record of `config`."""
    want = dict(config)
    if is_mnar(config):
        want["missing_rate"] = MNAR_ROW_MISSING_RATE
    with open(JAX_ROWS) as fh:
        for line in fh:
            rec = json.loads(line)
            if all(rec.get(k) == want[k] for k in
                   ("vae_type", "reg_type", "data_type", "batch_size",
                    "missing_rate")):
                return rec
    raise LookupError(f"no {config['vae_type']} / {config['reg_type']} row "
                      f"in {JAX_ROWS}")


def row_config(vae_type: str) -> dict:
    """The configuration of `vae_type`'s JAX row."""
    family = get_model(RunConfig(vae_type=vae_type)).name
    if family == "notmiwae":
        return dict(vae_type=vae_type, **MNAR_CONFIG)
    config = dict(vae_type=vae_type, **CONFIG)
    if family == "miwae":
        config.update(IW_SAMPLES)
    return config


def card_name() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def metric_names(config: dict) -> list:
    """The metrics a seed reports: an MNAR run's one RMSE, as the test
    RMSE; each split's four of `eval_vae` for an MCAR run."""
    if is_mnar(config):
        return ["test_rmse"]
    return [f"{stage}_{k}" for stage in ("train", "test") for k in METRICS]


def run_seed(config: dict, seed: int, epochs: int, device) -> dict:
    """Train and evaluate one seed; its metrics and wall-clock."""
    cfg = RunConfig(**config, epoch=epochs, seed=seed)
    load = loaders.data_loader_mnar if is_mnar(config) else loaders.data_loader
    ds = load(str(REPO / cfg.data_path), cfg.vae_type, cfg.missing_rate,
              cfg.batch_size, cfg.data_type, device=device)
    t0 = time.perf_counter()
    # train() reads each epoch's loss on the host: the card is done here
    params, history = train.train(ds, cfg, save=False, device=device)
    t_train = time.perf_counter() - t0
    if is_mnar(config):
        metrics = {"test_rmse": evaluate.eval_vae_mnar(
            ds.train.x, ds.train.mask, cfg, params=params, save=False,
            device=device)}
    else:
        res = evaluate.eval_vae(ds, cfg, params=params, save=False,
                                device=device)
        metrics = {f"{stage}_{k}": res[stage][k] for stage in res
                   for k in METRICS}
    t_all = time.perf_counter() - t0
    return {"seed": seed, "train_s": t_train, "eval_s": t_all - t_train,
            "first_epoch_loss": history[0], "last_epoch_loss": history[-1],
            **metrics}


def verdict(port: list, jax_mean: float, jax_std: float):
    """(port mean, port std, diff, tol, verdict) by PARITY.md's formula."""
    mean, std = float(np.mean(port)), float(np.std(port))
    diff = mean - jax_mean
    tol = 3 * (jax_std + std) + BAND * abs(jax_mean)
    if abs(diff) <= tol:
        word = "PARITY OK"
    elif diff < 0:
        word = "BETTER THAN REFERENCE"
    else:
        word = "WORSE - INVESTIGATE"
    return mean, std, diff, tol, word


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vae_type", default="reg_vae1",
                    help="the JAX row to hold the port against")
    ap.add_argument("--epochs", type=int, default=3000)
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    config = row_config(args.vae_type)
    names = metric_names(config)
    device = train.check_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    row = jax_row(config)
    jax_test = row["report"]["test"]["rmse"]
    card = card_name()
    print(f"{card}; torch {torch.__version__}, device {device}; "
          f"{config}, {args.epochs} epochs, seeds 0-{args.seeds - 1}",
          flush=True)

    seeds = []
    for seed in range(args.seeds):
        r = run_seed(config, seed, args.epochs, device)
        seeds.append(r)
        print(f"seed {seed}: train {r['train_s']:.3f} s, eval "
              f"{r['eval_s']:.3f} s; loss {r['first_epoch_loss']:.6f} -> "
              f"{r['last_epoch_loss']:.6f}", flush=True)
        print("  " + "  ".join(f"{k}={r[k]:.6f}" for k in names), flush=True)

    port_test = [r["test_rmse"] for r in seeds]
    mean, std, diff, tol, word = verdict(port_test, jax_test["ours_mean"],
                                         jax_test["ours_std"])
    means = {k: float(np.mean([r[k] for r in seeds])) for k in names}
    print(f"means over {args.seeds} seeds: " + "  ".join(
        f"{k}={v:.6f}" for k, v in means.items()), flush=True)
    print(f"test RMSE: port {mean:.6f} +- {std:.6f}, JAX "
          f"{jax_test['ours_mean']:.6f} +- {jax_test['ours_std']:.6f} "
          f"({row['seeds']} seeds); diff {diff:+.6f}, tol {tol:.6f} "
          f"(band {BAND}) -> {word} [{card}]", flush=True)
    result = {"config": config, "epochs": args.epochs, "card": card,
              "seeds": seeds, "means": means,
              "test_rmse": {"port_mean": mean, "port_std": std,
                            "jax_mean": jax_test["ours_mean"],
                            "jax_std": jax_test["ours_std"],
                            "jax_per_seed": row["per_seed"]["ours_test_rmse"],
                            "diff": diff, "tol": tol, "band": BAND},
              "verdict": word}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result), flush=True)
    return 0 if word == "PARITY OK" else 1


if __name__ == "__main__":
    sys.exit(main())

"""Impute the missing cells of your own CSV in one command (port of the
JAX package's `examples/impute_csv.py`).

Takes any numeric CSV whose missing cells are empty or `nan`, trains a
posterior-consistency model (by default reg_vae1 with kl_reg) on the
observed cells, and writes the completed CSV: the reference's research
pipeline (src/experiment_main/imputation.py) as one tool for any table.

Usage:
  python -m vae_posterior_consistency_tpu_torch.examples.impute_csv \\
      --input my_table.csv --output filled.csv [--epochs 1000] \\
      [--vae_type reg_vae1] [--alpha 1.0] [--device cpu]

Notes:
- each column is min-max scaled on its observed cells for training and
  scaled back on output (the reference's default transform); a column with
  no observed cell is left as it is, and its imputations come from the
  model alone;
- a missing cell's imputation is the trained decoder's mean given the row's
  observed cells (`engine/serve.ImputationServer`); observed cells are
  written back unchanged; each row's score goes to stderr;
- it runs on the card (`--device cuda`, the default; it raises without
  CUDA) or, with `--device cpu`, the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import io
import sys
import warnings

import numpy as np
import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.data.loaders import Dataset, Split
from vae_posterior_consistency_tpu_torch.engine import train as train_engine
from vae_posterior_consistency_tpu_torch.engine.serve import ImputationServer


def read_csv_with_nans(path: str) -> np.ndarray:
    with open(path) as fh:
        txt = fh.read()
    # empty fields become nan, so genfromtxt keeps the grid rectangular
    return np.genfromtxt(io.StringIO(txt), delimiter=",", dtype=np.float32)


def normalise(raw: np.ndarray):
    """(x, mask, lo, span): each column min-max scaled on its observed
    cells, missing cells 0 in x and in the float32 mask. A column with no
    observed cell keeps lo 0 and span 1, with a warning on stderr."""
    mask = (~np.isnan(raw)).astype(np.float32)
    filled0 = np.where(mask > 0, raw, 0.0)
    with np.errstate(all="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN columns
        lo = np.nanmin(raw, axis=0)
        hi = np.nanmax(raw, axis=0)
    # an all-NaN column has NaN lo and hi, and NaN * 0 is NaN: it would
    # poison every training input. There is nothing to learn from it.
    empty_cols = ~np.isfinite(lo)
    if empty_cols.any():
        print(f"warning: columns {np.flatnonzero(empty_cols).tolist()} have "
              f"no observed values; their imputations are unconditioned",
              file=sys.stderr)
        lo = np.where(empty_cols, 0.0, lo)
        hi = np.where(empty_cols, 1.0, hi)
    span = np.where(hi > lo, hi - lo, 1.0)
    x = (filled0 - lo) / span * mask  # missing cells zero
    return x, mask, lo, span


def impute_table(raw: np.ndarray, *, epochs: int = 1000,
                 vae_type: str = "reg_vae1", alpha: float = 1.0,
                 batch_size: int = 64, seed: int = 0, device="cuda",
                 params=None, noise=None, serve_noise=None):
    """Train on the observed cells of `raw` [N, D] (NaN = missing) and
    impute the rest; returns (the completed table, each row's score, the
    negative evidence bound: lower is better). `params` (a fresh init
    seeded with `seed` by default), `noise` (the trainer's source) and
    `serve_noise` (the server's) reach `train.train` and the server."""
    device = train_engine.check_device(device)
    x, mask, lo, span = normalise(raw)
    n, D = raw.shape
    cfg = RunConfig(vae_type=vae_type, epoch=epochs,
                    batch_size=min(batch_size, n), alpha=alpha,
                    p_missingness=30, reg_type="kl_reg", seed=seed, M=2)
    ds = Dataset(train=Split(torch.from_numpy(x), torch.from_numpy(mask),
                             "train"), test=None, obs_dim=D)
    params, _ = train_engine.train(ds, cfg, save=False, device=device,
                                   noise=noise, params=params)
    server = ImputationServer(params, cfg, D, buckets=(n,), device=device,
                              noise=serve_noise)
    filled_norm, row_score = server.impute(x, mask)
    filled = filled_norm * span + lo
    return np.where(mask > 0, raw, filled), row_score


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--vae_type", default="reg_vae1")
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    train_engine.check_device(args.device)

    raw = read_csv_with_nans(args.input)
    if raw.ndim == 1:
        raw = raw[:, None]
    n_missing = int(np.isnan(raw).sum())
    print(f"{args.input}: {raw.shape[0]} rows x {raw.shape[1]} cols, "
          f"{n_missing} missing cells "
          f"({100 * n_missing / raw.size:.1f}%)", file=sys.stderr)
    out, row_score = impute_table(
        raw, epochs=args.epochs, vae_type=args.vae_type, alpha=args.alpha,
        batch_size=args.batch_size, seed=args.seed, device=args.device)
    np.savetxt(args.output, out, delimiter=",", fmt="%.6g")
    print(f"wrote {args.output}; per-row score (lower=better): "
          f"median {np.median(row_score):.3f}", file=sys.stderr)


if __name__ == "__main__":
    main()

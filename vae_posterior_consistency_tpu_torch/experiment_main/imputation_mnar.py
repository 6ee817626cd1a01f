"""MNAR imputation experiment: train and evaluate every record of
`Data/imputation_args_mnar.json` (port of the serial grid of the JAX
package's `experiment_main/imputation_mnar.py`; reference:
src/experiment_main/imputation_mnar.py:27-85).

    python -m \
        vae_posterior_consistency_tpu_torch.experiment_main.imputation_mnar \
        [-<field> <value> ...] [-device cpu]

Run from the directory that holds `Data/`; checkpoints and artifacts go to
`experiments/` there. Each record is parsed with `config.setup_parser`, so a
CLI flag overrides that field in every record (a `-vae_type` too). For each
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
in the JAX package. Flags whose engine the port lacks (`-mesh`,
`-ensemble`, `-seeds` above 1, `-profile`) stop the run before it starts,
naming their slice.
"""

from __future__ import annotations

import os
import sys
import time

from vae_posterior_consistency_tpu_torch.config import (
    RunConfig,
    early_stopper,
    parse_alphas,
    parse_missings,
    restart_opts,
    setup_parser,
)
from vae_posterior_consistency_tpu_torch.data import loaders
from vae_posterior_consistency_tpu_torch.engine import evaluate
from vae_posterior_consistency_tpu_torch.engine import train as train_engine
from vae_posterior_consistency_tpu_torch.experiment_main.imputation import (
    open_grid,
)

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


def run_grid(records, probe, argv) -> None:
    """The serial grid: each record x missing x alpha trained, saved,
    evaluated and printed."""
    alphas = parse_alphas(probe, ALPHA_SWEEP)
    missings = parse_missings(probe, MISSING_SWEEP)
    for record in records:
        for missing in missings:
            for alpha in alphas:
                args = setup_parser(record, "impute_eval").parse_args(argv)
                cfg = RunConfig.from_args(args, alpha=alpha,
                                          p_missingness=missing,
                                          data_transform=DATA_TRANSFORM,
                                          not_miwae_type=NOT_MIWAE_TYPE)
                dataset = loaders.data_loader_mnar(
                    cfg.data_path, cfg.vae_type, cfg.missing_rate,
                    cfg.batch_size, cfg.data_type,
                    data_transform=DATA_TRANSFORM, device=args.device)
                print(f"=== train {cfg.vae_type} (MNAR, missing={missing}, "
                      f"alpha={alpha}) ===", flush=True)
                t0 = time.perf_counter()
                ck, rs = restart_opts(args)
                train_engine.train(dataset, cfg,
                                   log_fn=train_engine.epoch_logger(
                                       cfg.epoch), device=args.device,
                                   checkpoint_every=ck, resume=rs,
                                   early_stopping=early_stopper(args, cfg))
                t_train = time.perf_counter() - t0
                print(f"=== eval {cfg.vae_type} (MNAR) ===", flush=True)
                t0 = time.perf_counter()
                rmse = evaluate.eval_vae_mnar(dataset.train.x,
                                              dataset.train.mask, cfg,
                                              device=args.device)
                print(f"  rmse={rmse:.5f}")
                print(f"  [timing] train {t_train:.1f}s  "
                      f"eval {time.perf_counter() - t0:.1f}s", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    records, probe = open_grid(GRID, argv)
    run_grid(records, probe, argv)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except NotImplementedError as exc:
        sys.exit(f"imputation_mnar: {exc}")

"""Active variable selection over every record of `Data/imputation_args.json`
(port of the serial grid of the JAX package's
`experiment_main/active_learning.py`; reference:
src/experiment_main/active_learning.py:23-74).

    python -m \\
        vae_posterior_consistency_tpu_torch.experiment_main.active_learning \\
        [-<field> <value> ...] [-device cpu]

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

The run uses the card (`-device cuda`, the default; it raises without CUDA)
or, with `-device cpu`, the kernels' plain versions on the CPU. A record
the port cannot run yet (`compute_dtype` 'bfloat16') is named and skipped,
and the exit code is then 1. `-ensemble` and `-seeds` above 1 wait for
slice 9, `-mesh` for slice 10 and `-profile` for slice 11: they stop the
run before it starts (`imputation.open_grid`). `-checkpoint_every`,
`-resume` and `-early_stop` are accepted and ignored, as in the JAX
package: nothing trains here.
"""

from __future__ import annotations

import os
import sys
import time

from vae_posterior_consistency_tpu_torch.config import (
    RunConfig,
    parse_alphas,
    parse_missings,
    setup_parser,
)
from vae_posterior_consistency_tpu_torch.data import loaders
from vae_posterior_consistency_tpu_torch.engine import active_learning
from vae_posterior_consistency_tpu_torch.experiment_main.imputation import (
    open_grid,
    unported,
)

#: the grid, relative to the working directory
GRID = os.path.join("Data", "imputation_args.json")
#: hard-coded sweep axes (reference: src/experiment_main/active_learning.py)
MISSING_SWEEP = [30]
ALPHA_SWEEP = [1.0]


def run_grid(records, probe, argv) -> list:
    """The serial grid: one episode a record x missing x alpha; returns the
    runs not made, as (vae_type, missing, alpha, reason)."""
    alphas = parse_alphas(probe, ALPHA_SWEEP)
    missings = parse_missings(probe, MISSING_SWEEP)
    not_run = []
    for record in records:
        for missing in missings:
            for alpha in alphas:
                args = setup_parser(record, "impute_eval").parse_args(argv)
                cfg = RunConfig.from_args(args, alpha=alpha,
                                          p_missingness=missing)
                reason = unported(cfg)
                if reason is not None:
                    print(f"=== not run: {cfg.vae_type}: {reason} ===",
                          flush=True)
                    not_run.append((cfg.vae_type, missing, alpha, reason))
                    continue
                ds = loaders.data_loader(cfg.data_path, cfg.vae_type,
                                         cfg.missing_rate, cfg.batch_size,
                                         cfg.data_type, device=args.device)
                print(f"=== active learning {cfg.vae_type} ===", flush=True)
                t0 = time.perf_counter()
                out = active_learning.active_learning_func(
                    None, ds.test.x, ds.test.mask, cfg, Repeat=1,
                    device=args.device)
                curve = out["information_curve"][0, 0, :].tolist()
                print("  info curve (target MSE per #revealed): "
                      + " ".join(f"{v:.4f}" for v in curve))
                print(f"  [timing] episode {time.perf_counter() - t0:.1f}s",
                      flush=True)
    return not_run


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    records, probe = open_grid(GRID, argv)
    not_run = run_grid(records, probe, argv)
    if not_run:
        print(f"{len(not_run)} run(s) not made, not ported yet:", flush=True)
        for vae_type, missing, alpha, reason in not_run:
            print(f"  {vae_type} (missing={missing}, alpha={alpha}): "
                  f"{reason}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except NotImplementedError as exc:
        sys.exit(f"active_learning: {exc}")

"""AIS marginal-likelihood evaluation of a trained checkpoint (port of the
JAX package's `experiment_main/ais_eval.py`; reference: src/utils/AIS.py:
80-91, a library the reference wires into no script).

    python -m vae_posterior_consistency_tpu_torch.experiment_main.ais_eval \
        -vae_type reg_vae1 [-bdmc true] [-seeds N] [-<field> <value> ...] \
        [-device cpu]

Run from the directory that holds `Data/` and the `experiments/` tree that
`experiment_main/imputation.py` trained there. The record of
`Data/imputation_args.json` whose vae_type is `-vae_type` gives every
other default (missing_rate, epoch, data_type: the checkpoint's name), and
record 0 is used for a vae_type outside the grid. It loads the record's
data as the imputation entry point does, estimates log p(x) of both splits
with `engine/ais.eval_ais` at `n_ais_iwae` chains a row on the record's
`ais_schedule` / `n_ais_dist` bridge (artifacts under elbos/ and
latents/), and with `-bdmc true` runs `engine/ais.eval_bdmc`'s sandwich on
rows simulated from the model; then prints the JAX package's lines. With
`-seeds N` it loads the record's N seed-replica checkpoints (checkpoint.pt
and its `.seed{s}` siblings) and scores them together with
`engine/ais.eval_ais_ensemble` (artifacts `.seed{s}` for seed s), printing
each split's mean±std and every seed's estimate; `-bdmc` is then skipped,
as in the JAX package. `-ensemble` is accepted and ignored.

The run uses the card (`-device cuda`, the default; it raises without
CUDA) or, with `-device cpu`, the CPU. `-profile DIR` traces the
estimates (`config.maybe_profile`). `-mesh` resolves as in the JAX package
(`config.resolve_mesh`): on a mesh the chains of every estimate, the
seeds' and BDMC's too, are dp-sharded (`engine/ais`'s `mesh`), announced
by `mesh={...}: AIS chains dp-sharded`, and rank 0 alone prints and
writes (one process a device under torchrun). A record whose
compute_dtype is 'bfloat16' runs its chains in float32, as in the JAX
package: the AIS bridge's `log_lik` is not a model's `train_loss` or
`eval_step`, so nothing on it narrows.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vae_posterior_consistency_tpu_torch.config import (
    RunConfig,
    device_count,
    iter_jsonl_configs,
    maybe_profile,
    mesh_shape,
    resolve_mesh,
    setup_parser,
)
from vae_posterior_consistency_tpu_torch.engine import ais, checkpoint
from vae_posterior_consistency_tpu_torch.engine.train import check_device
from vae_posterior_consistency_tpu_torch.experiment_main.imputation import (
    GRID,
    load_dataset,
    start_up,
)
from vae_posterior_consistency_tpu_torch.parallel import multihost


def _record_for_vae_type(records, vae_type):
    """The JSONL record whose vae_type matches, so the checkpoint-path
    fields come from that record and not from record 0; record 0 for a
    vae_type outside the grid."""
    for rec in records:
        if rec["vae_type"]["default"] == vae_type:
            return rec
    return records[0]


def _run_seed_ensemble(dataset, cfg: RunConfig, n_seeds: int, bdmc: bool,
                       device, mesh=None) -> None:
    """`-seeds N`: the N seed-replica checkpoints scored together; BDMC
    certifies one checkpoint's schedule and is skipped."""
    params_ens = checkpoint.load_seed_ensemble(cfg, dataset.obs_dim, n_seeds,
                                               device=device)
    results = ais.eval_ais_ensemble(dataset, cfg, params_ens,
                                    n_sample=cfg.n_ais_iwae, mesh=mesh,
                                    device=device)
    for stage, res in results.items():
        # the float32 estimates, averaged in float32 as JAX's array is
        lw = res.logw.astype(np.float32)
        mu, sd = float(lw.mean()), float(lw.std())
        per = " ".join(f"s{s}={v:.4f}" for s, v in enumerate(res.logw))
        print(f"  [{stage}] AIS log p(x) = {mu:.4f}±{sd:.4f}  {per}")
    if bdmc:
        print("  [bdmc] skipped: -bdmc certifies one checkpoint's "
              "schedule; run it without -seeds")


def main(argv=None) -> int:
    try:
        return _main(sys.argv[1:] if argv is None else list(argv))
    finally:
        multihost.shutdown()


def _main(argv) -> int:
    start_up()
    records = list(iter_jsonl_configs(GRID))
    # two passes: argparse resolves the requested vae_type (`-vae_type=x`
    # and unambiguous abbreviations too), then the matching record gives
    # the defaults of the real parse
    probe = setup_parser(records[0], "ais_eval").parse_args(argv)
    record = _record_for_vae_type(records, probe.vae_type)
    args = setup_parser(record, "ais_eval").parse_args(argv)
    multihost.initialize(args.device)
    # a -mesh no device count satisfies raises mesh_shape's ValueError
    mesh_shape(args.mesh, device_count())
    with multihost.coordinator_stdout():
        return _run(args)


def _run(args) -> int:
    cfg = RunConfig.from_args(args)
    device = check_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "the CPU")
    print(f"Device: {device} ({name})", flush=True)
    dataset = load_dataset(cfg, device)
    mesh = resolve_mesh(cfg, device=args.device)
    if mesh is not None:
        print(f"mesh={dict(mesh.shape)}: AIS chains dp-sharded", flush=True)
    n_seeds = max(1, int(args.seeds))
    with maybe_profile(args):
        if n_seeds > 1:
            _run_seed_ensemble(dataset, cfg, n_seeds, args.bdmc, device,
                               mesh)
            return 0
        results = ais.eval_ais(dataset, cfg, n_sample=cfg.n_ais_iwae,
                               mesh=mesh, device=device)
        bdmc_res = (ais.eval_bdmc(dataset, cfg, n_sample=cfg.n_ais_iwae,
                                  mesh=mesh, device=device)
                    if args.bdmc else None)
    for stage, res in results.items():
        print(f"  [{stage}] AIS log p(x) = {res.logw:.4f}")
    if bdmc_res is not None:
        print(f"  [bdmc] sandwich on simulated data: "
              f"lower={bdmc_res.lower:.4f} upper={bdmc_res.upper:.4f} "
              f"gap={bdmc_res.gap:.4f} "
              f"(schedule={cfg.ais_schedule}, T={cfg.n_ais_dist})")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except NotImplementedError as exc:
        sys.exit(f"ais_eval: {exc}")

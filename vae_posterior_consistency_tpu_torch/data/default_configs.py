"""Generate the default JSONL sweep-config files (port of the JAX package's
`data/default_configs.py`; the files it writes are byte for byte the JAX
package's).

The reference drives its sweeps from two JSON-lines files whose records map
arg-name -> {type, default, help} (Data/imputation_args.json — 39 records;
Data/imputation_args_mnar.json — 2 records). This module regenerates
semantically identical files: same record order, same vae_type grid
(MIWAE/flow/vae/EDDI families x 3 data splits x suffix variants), same
per-family hyper-parameter defaults (verified against the reference records:
MIWAE rows use missing_rate=50, train_k=20, valid_k=5000, K=10, M=1; all other
MCAR rows use missing_rate=30, train_k=valid_k=1, M=50, with K=20 except the
reg_vae/reg_EDDI rows' K=10; MNAR rows use epoch=1, batch 128, valid_k=10000).
"""

from __future__ import annotations

import json
import os

_HELP = {
    "missing_rate": "percent of missingness",
    "vae_type": "type of the vae model",
    "experiment_type": "type of the experiment",
    "reg_type": "type of the regularization",
    "data_type": "type of the data",
    "epoch": "number of epochs for training",
    "batch_size": "input batch size for training",
    "patience": "number of iterations for early stopping for training",
    "data_path": "path to data files",
    "K": "Dimension of PNP feature map",
    "M": "Number of MC samples for imputation",
    "latent_dim": "latent dimension",
    "hid_dim": "hidden dimension",
    "train_k": "number of samples for iwae during the training",
    "valid_k": "number of samples for iwae during the validation",
    "n_iwae": "number of samples for iwae evaluation",
    "n_ais_iwae": "number of IMPORTANCE samples for AIS evaluation",
    "ais_schedule": "schedule for AIS",
    "n_ais_dist": "number of distributions for AIS evaluation",
    "num_estimates": "number of estimations for MIWAE(under missingness > 1)",
    "beta_annealing": "boolean value for beta annealing",
}


def _record(**overrides) -> dict:
    defaults = {
        "missing_rate": 30,
        "vae_type": "vanilla_vae1",
        "experiment_type": "UCI_experiments_consistency_missingness",
        "reg_type": "kl_reg",
        "data_type": "wine",
        "epoch": 3000,
        "batch_size": 64,
        "patience": 100,
        "data_path": "Data",
        "K": 20,
        "M": 50,
        "latent_dim": 10,
        "hid_dim": 500,
        "train_k": 1,
        "valid_k": 1,
        "n_iwae": 50,
        "n_ais_iwae": 40,
        "ais_schedule": "linear",
        "n_ais_dist": 50,
        "num_estimates": 100,
        "beta_annealing": False,
    }
    defaults.update(overrides)
    return {
        k: {"type": type(v).__name__, "default": v, "help": _HELP.get(k, "")}
        for k, v in defaults.items()
    }


def mcar_records() -> list:
    """The 39-record MCAR grid, in reference order."""
    recs = []
    miwae = dict(missing_rate=50, K=10, M=1, train_k=20, valid_k=5000)
    for fam in ("reg_MIWAE", "vanilla_MIWAE"):
        for i in (1, 2, 3):
            recs.append(_record(vae_type=f"{fam}{i}", **miwae))
    for fam in ("vanilla_flow", "reg_flow"):
        for i in (1, 2, 3):
            recs.append(_record(vae_type=f"{fam}{i}"))
    for suffix in ("_with_drop_mask_augm", "_mask_augm", "_with_drop", ""):
        for i in (1, 2, 3):
            recs.append(_record(vae_type=f"vanilla_vae{i}{suffix}"))
    for suffix in ("_with_drop", ""):
        for i in (1, 2, 3):
            recs.append(_record(vae_type=f"vanilla_EDDI{i}{suffix}"))
    for fam, k in (("reg_vae", 10), ("reg_EDDI", 10)):
        suffixes = ("_mask_augm", "") if fam == "reg_vae" else ("",)
        for suffix in suffixes:
            for i in (1, 2, 3):
                recs.append(_record(vae_type=f"{fam}{i}{suffix}", K=k))
    return recs


def mnar_records() -> list:
    """The 2-record MNAR grid (reference: Data/imputation_args_mnar.json)."""
    common = dict(
        missing_rate=30, epoch=1, batch_size=128, K=20, M=1,
        train_k=20, valid_k=10000, n_iwae=20,
    )
    return [
        _record(vae_type="vanilla_notMIWAE1", **common),
        _record(vae_type="reg_notMIWAE1", **common),
    ]


def write_default_configs(root: str = "Data", overwrite: bool = False) -> None:
    """Write the MCAR and MNAR grids under `root`; a file that exists is
    left as it is unless `overwrite`."""
    os.makedirs(root, exist_ok=True)
    targets = {
        "imputation_args.json": mcar_records(),
        "imputation_args_mnar.json": mnar_records(),
    }
    for fname, recs in targets.items():
        path = os.path.join(root, fname)
        if os.path.exists(path) and not overwrite:
            continue
        with open(path, "w") as fh:
            for rec in recs:
                fh.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    write_default_configs()

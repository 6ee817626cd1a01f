"""Run configuration: the `vae_type` master switch and the fields serving reads.

A copy of the JAX package's `config.py` contract (`parse_vae_type`,
`FAMILY_PRECEDENCE`, `VaeTypeInfo`, `RunConfig`) cut to what the port uses
so far; later slices add the argparse/JSONL layer.
"""

from __future__ import annotations

import dataclasses

#: model-family precedence, mirroring the reference factory's substring
#: dispatch order (src/utils/loaders.py:19-245): `flow` wins over `reg_vae`,
#: the final fallback is MIWAE.
FAMILY_PRECEDENCE = (
    "flow",
    "reg_vae",
    "reg_notMIWAE",
    "reg_EDDI",
    "reg_MIWAE",
    "vanilla_vae",
    "vanilla_EDDI",
    "vanilla_notMIWAE",
    "MIWAE",  # fallback (also matches vanilla_MIWAE)
)


@dataclasses.dataclass(frozen=True)
class VaeTypeInfo:
    """Decomposition of a `vae_type` string into its dispatch coordinates."""

    raw: str
    family: str  # one of FAMILY_PRECEDENCE
    regularized: bool  # reg_* family (trains a p-branch)
    flow: bool
    split_index: str  # first digit found in the string ('' if none)
    mask_augmented: bool  # `_mask_augm` suffix -> mask-concat encoder input
    with_drop: bool  # `_with_drop` suffix -> EDDI dropout masks in training


def parse_vae_type(vae_type: str) -> VaeTypeInfo:
    """Parse the `vae_type` master-switch string: family by substring
    precedence, split index = first digit (reference:
    src/utils/loaders.py:19-245, 322)."""
    family = "MIWAE"
    for cand in FAMILY_PRECEDENCE:
        if cand in vae_type:
            if cand == "flow" and "reg_flow" in vae_type:
                family = "reg_flow"
            elif cand == "flow":
                family = "vanilla_flow"
            else:
                family = cand
            break
    digits = [c for c in vae_type if c.isdigit()]
    return VaeTypeInfo(
        raw=vae_type,
        family=family,
        regularized=family.startswith("reg"),
        flow="flow" in vae_type,
        split_index=digits[0] if digits else "",
        mask_augmented="mask_augm" in vae_type,
        with_drop="with_drop" in vae_type,
    )


@dataclasses.dataclass
class RunConfig:
    """One run. Names and defaults follow the JAX package's `RunConfig` (the
    reference JSONL schema, Data/imputation_args.json line 1); only the
    fields that serving and checkpoint naming read are here."""

    missing_rate: int = 50
    vae_type: str = "reg_vae1"
    experiment_type: str = "UCI_experiments_consistency_missingness"
    reg_type: str = "kl_reg"  # 'kl_reg' | 'ml_reg'
    data_type: str = "wine"
    epoch: int = 3000
    K: int = 10  # PointNet feature-map dim
    latent_dim: int = 10
    beta_annealing: bool = False
    alpha: float = 1.0
    p_missingness: int = 30
    beta: float = 1.0
    seed: int = 0
    #: 'float32' only in the port so far; 'bfloat16' comes with the
    #: mixed-precision slice (models/registry.get_model raises)
    compute_dtype: str = "float32"

    @property
    def info(self) -> VaeTypeInfo:
        return parse_vae_type(self.vae_type)

"""vae_type -> model implementation dispatch (port of the JAX package's
`models/registry.py`). The port has the gauss family so far; every other
family raises NotImplementedError naming the slice that brings it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from vae_posterior_consistency_tpu_torch.config import RunConfig, parse_vae_type
from vae_posterior_consistency_tpu_torch.models import gauss


@dataclasses.dataclass(frozen=True)
class ModelDef:
    """A model family's function surface."""

    name: str
    init: Callable  # (generator, cfg, obs_dim, device) -> params
    #: (params, x, mask, mask_p, eps, epoch, cfg, eps_z=None) -> (loss, aux)
    train_loss: Callable
    eval_step: Callable  # (params, x, mask, mask_p, eps, cfg) -> dict
    uses_p_branch: bool


_GAUSS = ModelDef(
    name="gauss",
    init=gauss.init,
    train_loss=gauss.train_loss,
    eval_step=gauss.eval_step,
    uses_p_branch=True,  # refined per vae_type in get_model
)

_FAMILY_TO_DEF = {
    "reg_vae": _GAUSS,
    "reg_EDDI": _GAUSS,
    "vanilla_vae": _GAUSS,
    "vanilla_EDDI": _GAUSS,
}

#: families not ported yet -> the slice (ROADMAP.md queue A) that ports them
_LATER = {
    "vanilla_flow": "the flow slice",
    "reg_flow": "the flow slice",
    "reg_notMIWAE": "the importance-weighted slice",
    "vanilla_notMIWAE": "the importance-weighted slice",
    "reg_MIWAE": "the importance-weighted slice",
    "MIWAE": "the importance-weighted slice",
}


def get_model(cfg: RunConfig) -> ModelDef:
    info = parse_vae_type(cfg.vae_type)
    if info.family in _LATER:
        raise NotImplementedError(
            f"vae_type {cfg.vae_type!r} (family {info.family}) is not ported "
            f"yet; it comes with {_LATER[info.family]}")
    if cfg.compute_dtype == "bfloat16":
        raise NotImplementedError(
            "compute_dtype='bfloat16' is not ported yet; it comes with the "
            "mixed-precision slice")
    if cfg.compute_dtype != "float32":
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', "
                         f"got {cfg.compute_dtype!r}")
    return dataclasses.replace(_FAMILY_TO_DEF[info.family],
                               uses_p_branch=info.regularized)

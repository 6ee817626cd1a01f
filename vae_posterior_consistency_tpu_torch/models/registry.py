"""vae_type -> model implementation dispatch (port of the JAX package's
`models/registry.py`). The port has the gauss and flow families so far;
every other family raises NotImplementedError naming the slice that brings
it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from vae_posterior_consistency_tpu_torch.config import RunConfig, parse_vae_type
from vae_posterior_consistency_tpu_torch.models import flow_vae, gauss


@dataclasses.dataclass(frozen=True)
class ModelDef:
    """A model family's function surface."""

    name: str
    init: Callable  # (generator, cfg, obs_dim, device) -> params
    #: (params, x, mask, mask_p, eps, epoch, cfg, eps_z=None) -> (loss, aux)
    train_loss: Callable
    eval_step: Callable  # (params, x, mask, mask_p, eps, cfg) -> dict
    uses_p_branch: bool
    #: 'vae' (rmse, loss, negl, negl_imp) | 'miwae' (rmse only, valid_k
    #: importance samples; comes with the importance-weighted slice)
    eval_kind: str = "vae"
    #: flow-posterior log-prob hook of the ratio-version AL reward
    #: (reference: src/experiment_main/evaluate.py:637-708):
    #: (params, x, mask, eps, cfg) -> [B, L]
    encode_sample_logprob: Optional[Callable] = None


def _flow_sample_logprob(params, x, mask, eps, cfg):
    _, log_prob = flow_vae.encode(params, x, mask, eps, cfg)
    return log_prob


_GAUSS = ModelDef(
    name="gauss",
    init=gauss.init,
    train_loss=gauss.train_loss,
    eval_step=gauss.eval_step,
    uses_p_branch=True,  # refined per vae_type in get_model
)

_FLOW = ModelDef(
    name="flow",
    init=flow_vae.init,
    train_loss=flow_vae.train_loss,
    eval_step=flow_vae.eval_step,
    uses_p_branch=True,  # refined per vae_type in get_model
    encode_sample_logprob=_flow_sample_logprob,
)

_FAMILY_TO_DEF = {
    "vanilla_flow": _FLOW,
    "reg_flow": _FLOW,
    "reg_vae": _GAUSS,
    "reg_EDDI": _GAUSS,
    "vanilla_vae": _GAUSS,
    "vanilla_EDDI": _GAUSS,
}

#: families not ported yet -> the slice (ROADMAP.md queue A) that ports them
_LATER = {
    "reg_notMIWAE": "slice 7, the importance-weighted slice",
    "vanilla_notMIWAE": "slice 7, the importance-weighted slice",
    "reg_MIWAE": "slice 7, the importance-weighted slice",
    "MIWAE": "slice 7, the importance-weighted slice",
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

"""vae_type -> model implementation dispatch (port of the JAX package's
`models/registry.py`): the gauss, flow, MIWAE and notMIWAE families.
`compute_dtype='bfloat16'` runs a model's `train_loss` and `eval_step`
under `nn/core.compute_dtype`; its other functions (`encode_stats`,
`encode_sample_logprob`, the AIS bridge) stay float32, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig, parse_vae_type
from vae_posterior_consistency_tpu_torch.models import (
    flow_vae,
    gauss,
    miwae,
    notmiwae,
)
from vae_posterior_consistency_tpu_torch.nn import core


@dataclasses.dataclass(frozen=True)
class ModelDef:
    """A model family's function surface."""

    name: str
    init: Callable  # (generator, cfg, obs_dim, device) -> params
    #: (params, x, mask, mask_p, eps, epoch, cfg, **extra) -> (loss, aux),
    #: `extra` the kinds of `train_noise` other than "eps"
    train_loss: Callable
    eval_step: Callable  # (params, x, mask, mask_p, eps, cfg) -> dict
    #: (cfg, B, D) -> {noise kind: shape}, the draws of a training step
    #: (always "eps") and of an evaluation batch ("eps", and "mask_p"
    #: where `eval_step` reads a mask_p), in the order they are drawn
    train_noise: Callable
    eval_noise: Callable
    #: (cfg) -> {noise kind: its batch-row axis}, for `train_noise` and
    #: `eval_noise`: a multi-device run draws a global batch's noise and
    #: takes each rank's rows along these axes (`parallel/train_parallel`)
    train_noise_rows: Callable
    eval_noise_rows: Callable
    uses_p_branch: bool
    #: 'vae' (four artifacts a split) | 'miwae' (the rmse artifact only,
    #: cfg.valid_k importance samples)
    eval_kind: str = "vae"
    #: Gaussian posterior statistics of the AL information reward and the
    #: MI diagnostics (reference: src/experiment_main/evaluate.py:546-634):
    #: (params, x, mask, cfg) -> (mean, logvar), both [B, L]
    encode_stats: Optional[Callable] = None
    #: flow-posterior log-prob hook of the ratio-version AL reward
    #: (reference: src/experiment_main/evaluate.py:637-708):
    #: (params, x, mask, eps, cfg) -> [B, L]
    encode_sample_logprob: Optional[Callable] = None


def _miwae_encode_stats(params, x, mask, cfg):
    """The MIWAE encoder's statistics as (mean, logvar): its softplus std
    becomes logvar = 2 log scale. (The reference feeds the scale itself
    where a logvar is expected, evaluate.py:562-564 with VAE.py:3175-3188;
    the JAX package implements the intent, and so does the port.)"""
    mean, scale = miwae.encode(params, x, mask, cfg)
    return mean, 2.0 * torch.log(scale)


def _flow_sample_logprob(params, x, mask, eps, cfg):
    _, log_prob = flow_vae.encode(params, x, mask, eps, cfg)
    return log_prob


def _def(name, module, **kw):
    return ModelDef(name=name, init=module.init,
                    train_loss=module.train_loss,
                    eval_step=module.eval_step,
                    train_noise=module.train_noise,
                    eval_noise=module.eval_noise,
                    train_noise_rows=module.train_noise_rows,
                    eval_noise_rows=module.eval_noise_rows,
                    uses_p_branch=True,  # refined per vae_type in get_model
                    **kw)


_GAUSS = _def("gauss", gauss, encode_stats=gauss.encode)
_FLOW = _def("flow", flow_vae, encode_sample_logprob=_flow_sample_logprob)
_MIWAE = _def("miwae", miwae, eval_kind="miwae",
              encode_stats=_miwae_encode_stats)
_NOTMIWAE = _def("notmiwae", notmiwae, eval_kind="miwae",
                 encode_stats=notmiwae.encode)

_FAMILY_TO_DEF = {
    "vanilla_flow": _FLOW,
    "reg_flow": _FLOW,
    "reg_vae": _GAUSS,
    "reg_EDDI": _GAUSS,
    "vanilla_vae": _GAUSS,
    "vanilla_EDDI": _GAUSS,
    "reg_notMIWAE": _NOTMIWAE,
    "vanilla_notMIWAE": _NOTMIWAE,
    "reg_MIWAE": _MIWAE,
    # vanilla_MIWAE falls back to the MIWAE family (config.parse_vae_type)
    "MIWAE": _MIWAE,
}


@functools.cache
def _dtype_wrapped(fn: Callable, dtype: str) -> Callable:
    """`fn` (a model's train_loss or eval_step) run under
    core.compute_dtype(dtype). Memoised, so that two get_model(cfg) calls
    return equal ModelDefs."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with core.compute_dtype(dtype):
            return fn(*args, **kwargs)

    return wrapped


def get_model(cfg: RunConfig) -> ModelDef:
    info = parse_vae_type(cfg.vae_type)
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        # nn/core.dense tests for the exact string 'bfloat16'; any other
        # spelling would run float32 while claiming mixed precision
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', "
                         f"got {cfg.compute_dtype!r}")
    model = dataclasses.replace(_FAMILY_TO_DEF[info.family],
                                uses_p_branch=info.regularized)
    if cfg.compute_dtype != "float32":
        model = dataclasses.replace(
            model,
            train_loss=_dtype_wrapped(model.train_loss, cfg.compute_dtype),
            eval_step=_dtype_wrapped(model.eval_step, cfg.compute_dtype))
    return model

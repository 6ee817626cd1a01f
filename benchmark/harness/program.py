"""What the drivers take from the system under test: its run
configuration, its parameter layout and its model, set as a cell's
configuration file and variant say. Nothing else of the program is read
here; the drivers call its entry points."""

from __future__ import annotations

import dataclasses

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.engine import checkpoint
from vae_posterior_consistency_tpu_torch.models import get_model

#: the configuration file's keys that are RunConfig fields
_FIELDS = ("vae_type", "reg_type", "data_type", "batch_size", "K", "M",
           "latent_dim", "missing_rate", "p_missingness", "alpha", "beta",
           "epoch", "beta_annealing")


def run_config(config: dict, variant=None, **fields) -> RunConfig:
    """The program's RunConfig for `config`, with `fields` set over it; the
    variant 'bf16' turns on the program's own lower-precision path
    (compute_dtype='bfloat16')."""
    kw = {k: config[k] for k in _FIELDS if k in config}
    dtype = "bfloat16" if variant == "bf16" else config["compute_dtype"]
    return RunConfig(compute_dtype=dtype, **{**kw, **fields})


def nested(flat: dict) -> dict:
    """Flat parameters {"encoder/pnp1/layer0/w": t} in the program's
    nested layout (a copy of each leaf)."""
    return checkpoint.unflatten({k: v.detach().clone()
                                 for k, v in flat.items()})


def flat(params: dict) -> dict:
    return checkpoint.flatten(params)


def replace(model_def, **fns):
    """A ModelDef with functions replaced."""
    return dataclasses.replace(model_def, **fns)


def model(rc: RunConfig, **fns):
    """The program's ModelDef for `rc`, with functions replaced (the
    faults of the harness's own tests)."""
    return replace(get_model(rc), **fns)

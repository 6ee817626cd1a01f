"""Checkpoints: reference-mangled paths, the JAX package's flat-key `.pt`
format (save and load), and trained reference state_dicts (gauss family).

The JAX package saves a flat dict {"encoder/pnp1/layer0/w": ndarray, ...}
with torch.save (its `engine/checkpoint.py`); weights are [fan_in, fan_out],
the layout the port keeps, so its parameters map leaf for leaf. The
reference's own state_dicts (`src/experiment_main/train.py:120-131`) name
torch modules and store Linear weights [out, in]; `convert_state_dict` maps
them as `tools/convert_reference_checkpoint.py` does for the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.models.gauss import _is_pointnet


def family_dir(vae_type: str) -> str:
    """Digit-stripped first-two-words family directory
    (reference: src/experiment_main/train.py:122-124)."""
    return "".join(
        c for c in "_".join(vae_type.split("_")[:2]) if not c.isdigit()
    )


def checkpoint_path(cfg: RunConfig, root: str = "experiments") -> str:
    """Exact reference checkpoint filename (src/experiment_main/train.py:120-131)."""
    base = os.path.join(
        root, cfg.experiment_type, cfg.data_type, "checkpoints",
        family_dir(cfg.vae_type),
    )
    if "vanilla" in cfg.vae_type:
        name = (
            f"checkpoint_{cfg.vae_type}_{cfg.missing_rate}_missing_rate_test.pt"
        )
    else:
        name = (
            f"checkpoint_{cfg.vae_type}_{cfg.alpha}_{cfg.p_missingness}_"
            f"{cfg.reg_type}_{cfg.missing_rate}_missing_rate_full_reg_test.pt"
        )
    return os.path.join(base, name)


def flatten(params: dict, prefix: str = "") -> dict:
    """Nested parameter dict -> {"a/b/c": leaf}, the checkpoint key layout."""
    flat = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat


def unflatten(flat: dict) -> dict:
    """{"a/b/c": leaf} -> nested parameter dict (the inverse of `flatten`)."""
    params: dict = {}
    for key, leaf in flat.items():
        *parents, name = key.split("/")
        node = params
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return params


def params_from_jax(flat: dict, device) -> dict:
    """The JAX package's flat parameters {"encoder/layer0/w": ndarray, ...}
    (its checkpoint contents) -> the port's nested dict of tensors on
    `device`. Same keys, same layouts, same values."""
    return unflatten({k: torch.tensor(np.asarray(v), device=device)
                      for k, v in flat.items()})


def save(params: dict, path: str) -> None:
    """Write `params` in the JAX package's flat-key format: `torch.save` of
    {"encoder/layer0/w": float32 ndarray, ...}, weights [fan_in, fan_out]
    (its engine/checkpoint.save), so the JAX `load`/`load_trained` reads
    it. Parent directories are made."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    torch.save({k: np.asarray(v.detach().cpu().numpy(), dtype=np.float32)
                for k, v in flatten(params).items()}, path)


def load(template_params: dict, path: str) -> dict:
    """Load a JAX-package checkpoint into the structure of `template_params`
    (from a fresh `init`), on the template's devices and dtypes."""
    flat = torch.load(path, map_location="cpu", weights_only=False)
    out = {}
    for key, leaf in flatten(template_params).items():
        arr = np.asarray(flat[key])
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape}, "
                             f"expected {tuple(leaf.shape)}")
        out[key] = torch.tensor(arr, device=leaf.device, dtype=leaf.dtype)
    return unflatten(out)


# ---------------------------------------------------------------------------
# reference state_dicts (gauss family)
# ---------------------------------------------------------------------------


def _np(t):
    return np.asarray(t.detach().cpu().numpy(), dtype=np.float32)


def _linear(sd, prefix):
    """One torch nn.Linear -> dense params (weight transposed)."""
    return {"w": _np(sd[f"{prefix}.weight"]).T, "b": _np(sd[f"{prefix}.bias"])}


def _seq_mlp(sd, prefix):
    """A torch nn.Sequential of Linears (+activations) -> mlp_init layout:
    the Linears' Sequential indices (0, 2, 4, ...) become layer0, layer1, ..."""
    idxs = sorted(
        int(k[len(prefix) + 1:].split(".")[0])
        for k in sd
        if k.startswith(prefix + ".") and k.endswith(".weight")
    )
    if not idxs:
        raise KeyError(f"no Linear weights under '{prefix}.*' in state_dict")
    return {f"layer{j}": _linear(sd, f"{prefix}.{i}")
            for j, i in enumerate(idxs)}


def _convert_gauss(sd, cfg):
    if _is_pointnet(cfg):
        encoder = {
            "pnp1": _seq_mlp(sd, "pnp_encoder1"),
            "pnp2": _seq_mlp(sd, "pnp_encoder2"),
            "type_pars": _np(sd["type_pars1"]),
            "type_bias": _np(sd["type_bias1"]),
        }
    else:
        encoder = _seq_mlp(sd, "seq_encoder")
    return {"encoder": encoder, "decoder": _seq_mlp(sd, "seq_decoder")}


class _TrackedDict(dict):
    """Records which keys were read, so a key-mapping gap fails loudly
    instead of silently dropping trained weights."""

    def __init__(self, *a):
        super().__init__(*a)
        self.consumed = set()

    def __getitem__(self, k):
        self.consumed.add(k)
        return super().__getitem__(k)


def convert_state_dict(sd, cfg: RunConfig, obs_dim: int) -> dict:
    """Reference torch state_dict of a gauss-family model -> nested dict of
    numpy arrays in the JAX/port layout. Raises on unread tensors (other
    than the registered `prior_*` constants) and on shapes that differ from
    the model's."""
    model = get_model(cfg)  # raises for families the port does not have
    sd = _TrackedDict(sd)
    params = _convert_gauss(sd, cfg)
    unconsumed = [k for k in sd
                  if k not in sd.consumed and not k.startswith("prior_")]
    if unconsumed:
        raise ValueError(
            "reference state_dict tensors not consumed by the converter "
            f"(key-mapping gap, trained weights would be dropped): "
            f"{sorted(unconsumed)}")
    template = flatten(model.init(torch.Generator().manual_seed(0), cfg,
                                  obs_dim, device="cpu"))
    got = flatten(params)
    if set(got) != set(template):
        raise ValueError(f"converted leaves {sorted(set(got) ^ set(template))} "
                         "do not match the model's")
    for key, leaf in template.items():
        if got[key].shape != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {key}: converted "
                             f"{got[key].shape} vs model {tuple(leaf.shape)}")
    return params


def load_reference(path: str, cfg: RunConfig, obs_dim: int,
                   device="cuda") -> dict:
    """Read a trained reference state_dict and return the port's params."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return params_from_jax(flatten(convert_state_dict(sd, cfg, obs_dim)),
                           device)

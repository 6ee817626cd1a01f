"""Checkpoints: reference-mangled paths, the JAX package's flat-key `.pt`
format (save and load; `save_many` for an ensemble's replicas, the
`.seed{s}` names of seed replicas and `load_seed_ensemble`), its
mid-training `.resume.pt` files (parameters, Adam state, epochs done, the
run's identity tag; an ensemble's hold its stacked [S, ...] leaves), and
trained reference state_dicts (gauss family).

The JAX package saves a flat dict {"encoder/pnp1/layer0/w": ndarray, ...}
with torch.save (its `engine/checkpoint.py`); weights are [fan_in, fan_out],
the layout the port keeps, so its parameters map leaf for leaf. The
reference's own state_dicts (`src/experiment_main/train.py:120-131`) name
torch modules and store Linear weights [out, in]; `convert_state_dict` maps
them as `tools/convert_reference_checkpoint.py` does for the JAX package.

A list in the parameters (the flow's `actnorm`, one dict a spline layer) is
keyed by its indices, as JAX's tree paths key it: "actnorm/0/log_scale",
"actnorm/0/shift", "actnorm/1/log_scale", ...; a top-level leaf (the
notMIWAE missing process's "W" and "b") by its name alone.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import zlib

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


def flatten(params, prefix: str = "") -> dict:
    """Nested parameters (dicts, lists) -> {"a/b/c": leaf}, the checkpoint
    key layout; a list's entries are keyed by their indices."""
    items = (params.items() if isinstance(params, dict)
             else enumerate(params))
    flat = {}
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            flat.update(flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat


def _lists(node):
    """Turn every dict keyed exactly "0".."n-1" back into a list."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and sorted(node) == [str(i) for i in range(len(node))]:
        return [node[str(i)] for i in range(len(node))]
    return node


def unflatten(flat: dict) -> dict:
    """{"a/b/c": leaf} -> nested parameters (the inverse of `flatten`)."""
    params: dict = {}
    for key, leaf in flat.items():
        *parents, name = key.split("/")
        node = params
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return _lists(params)


def on_device(params, device) -> dict:
    """A detached float32 copy of nested parameters (dicts, lists) on
    `device`."""
    return unflatten({k: v.detach().to(device=device, dtype=torch.float32)
                      for k, v in flatten(params).items()})


def params_from_jax(flat: dict, device) -> dict:
    """The JAX package's flat parameters {"encoder/layer0/w": ndarray, ...}
    (its checkpoint contents) -> the port's nested dict of tensors on
    `device`. Same keys, same layouts, same values."""
    return unflatten({k: torch.tensor(np.asarray(v), device=device)
                      for k, v in flat.items()})


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), dtype=np.float32)


def save(params: dict, path: str) -> None:
    """Write `params` in the JAX package's flat-key format: `torch.save` of
    {"encoder/layer0/w": float32 ndarray, ...}, weights [fan_in, fan_out]
    (its engine/checkpoint.save), so the JAX `load`/`load_trained` reads
    it. Parent directories are made."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    torch.save({k: _np(v) for k, v in flatten(params).items()}, path)


def _restore(flat: dict, template_params: dict, prefix: str = "") -> dict:
    """The leaves `prefix + key` of a loaded flat dict, in the structure,
    devices and dtypes of `template_params`. KeyError for a missing leaf,
    ValueError for a shape that differs."""
    out = {}
    for key, leaf in flatten(template_params).items():
        arr = np.asarray(flat[prefix + key])
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {prefix + key!r} has shape "
                             f"{arr.shape}, expected {tuple(leaf.shape)}")
        out[key] = torch.tensor(arr, device=leaf.device, dtype=leaf.dtype)
    return unflatten(out)


def load(template_params: dict, path: str) -> dict:
    """Load a JAX-package checkpoint into the structure of `template_params`
    (from a fresh `init`), on the template's devices and dtypes."""
    return _restore(torch.load(path, map_location="cpu", weights_only=False),
                    template_params)


def save_many(pairs) -> None:
    """Write [(params, path)] checkpoints through a small thread pool (the
    JAX package's engine/checkpoint.py:109-129): the writes of an
    ensemble's replicas overlap. Joins before returning."""
    pairs = list(pairs)
    if len(pairs) <= 1:
        for p, path in pairs:
            save(p, path)
        return
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=8) as pool:
        for f in [pool.submit(save, p, path) for p, path in pairs]:
            f.result()


def seed_suffix(s: int) -> str:
    """The checkpoint suffix of seed replica s: '' for seed 0, which keeps
    the reference's names, '.seed{s}' for the others (the JAX package's
    engine/checkpoint.py:218-222)."""
    return "" if s == 0 else f".seed{s}"


def load_seed_ensemble(cfg: RunConfig, obs_dim: int, n_seeds: int,
                       root: str = "experiments", device="cuda") -> dict:
    """The n_seeds seed-replica checkpoints of one config (checkpoint.pt
    and its `.seed{s}` siblings) stacked on a leading [S] axis, the layout
    the ensemble evaluators take (engine/checkpoint.py:225-240).
    FileNotFoundError names a seed that was never trained."""
    model = get_model(cfg)
    template = model.init(torch.Generator(device=device).manual_seed(0), cfg,
                          obs_dim, device=device)
    base = checkpoint_path(cfg, root)
    replicas = [flatten(load(template, base + seed_suffix(s)))
                for s in range(n_seeds)]
    return unflatten({k: torch.stack([r[k] for r in replicas])
                      for k in replicas[0]})


# ---------------------------------------------------------------------------
# mid-training resume files
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdamState:
    """Adam's state as optax keeps it: one step `count` for all leaves and
    the first and second moments `mu`, `nu`, nested like the parameters."""

    count: int
    mu: dict
    nu: dict


def adam_state(optimizer: torch.optim.Adam, params: dict) -> AdamState:
    """torch Adam's per-parameter `step`, `exp_avg`, `exp_avg_sq` -> one
    AdamState. A leaf Adam has never stepped (no gradient reached it, as
    the flow decoder's dead logvar head) has zero moments, as in optax,
    whose count is shared."""
    count, mu, nu = 0, {}, {}
    for key, p in flatten(params).items():
        state = optimizer.state.get(p, {})
        if state:
            count = max(count, int(state["step"]))
            mu[key], nu[key] = state["exp_avg"], state["exp_avg_sq"]
        else:
            mu[key] = nu[key] = torch.zeros_like(p)
    return AdamState(count, unflatten(mu), unflatten(nu))


def load_adam_state(optimizer: torch.optim.Adam, params: dict,
                    state: AdamState) -> None:
    """Fill `optimizer` (built over `params`' leaves) with a copy of
    `state`, every leaf's `step` set to its count. Goes through
    `load_state_dict`, which puts each tensor on the device and in the
    dtype Adam expects (and keeps a tensor already there as it is: hence
    the copy)."""
    index = {id(p): i for i, p in enumerate(optimizer.param_groups[0]
                                            ["params"])}
    mu, nu = flatten(state.mu), flatten(state.nu)
    sd = optimizer.state_dict()
    sd["state"] = {} if state.count == 0 else {
        index[id(p)]: {"step": torch.tensor(float(state.count)),
                       "exp_avg": mu[key].clone(),
                       "exp_avg_sq": nu[key].clone()}
        for key, p in flatten(params).items()}
    optimizer.load_state_dict(sd)


def _tag_hash(tag: str) -> np.int64:
    return np.int64(zlib.crc32(tag.encode("utf-8")))


def save_resume(params: dict, opt_state: AdamState, epoch: int, path: str,
                tag: str = "") -> None:
    """Write mid-training restart state (parameters, Adam state, epochs
    done) in the JAX package's `.resume.pt` layout, key for key: the
    float32 "params/<key>", "opt_state/0/.mu/<key>" and
    "opt_state/0/.nu/<key>", the int32 "opt_state/0/.count" and "epoch",
    and the int64 "tag", crc32 of the run's identity `tag`. Either package
    reads what the other writes. The file is written to `path + '.tmp'`
    and renamed into place, so a crash while writing leaves the previous
    file whole."""
    flat = {"params/" + k: _np(v) for k, v in flatten(params).items()}
    flat["opt_state/0/.count"] = np.asarray(opt_state.count, np.int32)
    for name, moments in (("mu", opt_state.mu), ("nu", opt_state.nu)):
        flat.update({f"opt_state/0/.{name}/{k}": _np(v)
                     for k, v in flatten(moments).items()})
    flat["epoch"] = np.asarray(epoch, np.int32)
    flat["tag"] = np.asarray(_tag_hash(tag))
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    torch.save(flat, tmp)
    os.replace(tmp, path)


def load_resume(template_params: dict, path: str, tag: str = "",
                max_epochs: int | None = None):
    """Read a `save_resume` file (of either package) back into (params,
    AdamState, epochs_done), shaped, placed and typed like
    `template_params`. Raises RuntimeError, with the JAX package's
    messages, when the file's layout does not match this model, when its
    identity tag differs from `tag`, and when it has trained more epochs
    than `max_epochs`."""
    try:
        flat = torch.load(path, map_location="cpu", weights_only=False)
        params = _restore(flat, template_params, "params/")
        mu = _restore(flat, template_params, "opt_state/0/.mu/")
        nu = _restore(flat, template_params, "opt_state/0/.nu/")
        scalars = {k: np.asarray(flat[k]) for k in
                   ("opt_state/0/.count", "epoch", "tag")}
        for k, v in scalars.items():
            if v.shape != ():
                raise ValueError(f"checkpoint leaf {k!r} has shape "
                                 f"{v.shape}, expected ()")
    # only structural mismatches get the delete-the-file advice; I/O
    # failures propagate untouched
    except (KeyError, ValueError, TypeError, pickle.UnpicklingError) as e:
        raise RuntimeError(
            f"cannot resume from {path}: its layout does not match this "
            "engine/config (files written before the pytree-runner "
            "migration stored a flat vector under a 'pflat' key; files "
            "written before round 5 carry no identity tag). Delete the "
            ".resume.pt to restart from scratch."
        ) from e
    if int(scalars["tag"]) != int(_tag_hash(tag)):
        raise RuntimeError(
            f"cannot resume from {path}: it was written by a run with "
            f"different sweep values than this one ({tag!r}). Delete the "
            ".resume.pt to restart from scratch, or rerun with the "
            "original sweep flags."
        )
    done = int(scalars["epoch"])
    if max_epochs is not None and done > max_epochs:
        raise RuntimeError(
            f"cannot resume from {path}: it has already trained {done} "
            f"epochs but this run asks for only {max_epochs}. Delete the "
            ".resume.pt to retrain from scratch at the smaller budget, or "
            "rerun with the original -epoch."
        )
    return (params, AdamState(int(scalars["opt_state/0/.count"]), mu, nu),
            done)


# ---------------------------------------------------------------------------
# reference state_dicts (gauss family)
# ---------------------------------------------------------------------------


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
    if model.name != "gauss":
        raise NotImplementedError(
            f"vae_type {cfg.vae_type!r}: reference state_dicts are mapped "
            "for the gauss family only so far; the converter for every "
            "family comes with slice 11")
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

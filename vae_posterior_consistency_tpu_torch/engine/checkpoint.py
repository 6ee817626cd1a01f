"""Checkpoints: reference-mangled paths, the JAX package's flat-key `.pt`
format (save and load; `save_many` for an ensemble's replicas, the
`.seed{s}` names of seed replicas and `load_seed_ensemble`), its
mid-training `.resume.pt` files (parameters, Adam state, epochs done, the
run's identity tag; an ensemble's hold its stacked [S, ...] leaves), and
the reference's own state_dicts of every family, read
(`convert_state_dict`) and written (`export_state_dict`).

The JAX package saves a flat dict {"encoder/pnp1/layer0/w": ndarray, ...}
with torch.save (its `engine/checkpoint.py`); weights are [fan_in, fan_out],
the layout the port keeps, so its parameters map leaf for leaf. The
reference's own state_dicts (`src/experiment_main/train.py:120-131`) name
torch modules and store Linear weights [out, in]; `convert_state_dict` and
`export_state_dict` map them as the JAX package's
`tools/convert_reference_checkpoint.py` does, tensor for tensor.

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
    """A tensor or array as a float32 numpy array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


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
# reference state_dicts (every family, both ways)
# ---------------------------------------------------------------------------
#
# torch module names of the reference -> the port's nested parameters:
#   gauss dense      seq_encoder.{0,2,4}    -> encoder.layer{0,1,2}
#                    seq_decoder.{0,2,4}    -> decoder.layer{0,1,2}
#   gauss EDDI       pnp_encoder1.0         -> encoder.pnp1.layer0
#                    pnp_encoder2.{0,2,..}  -> encoder.pnp2.layer{i}
#                    type_pars1/type_bias1  -> encoder.type_pars/type_bias
#   MIWAE            seq_encoder, seq_decoder as gauss dense
#   notMIWAE         seq_encoder.{0,2}      -> encoder.trunk.layer{0,1}
#                    q_mu.0 / q_logstd.0    -> encoder.q_mu/q_logstd.layer0
#                    seq_decoder.{0,2}      -> decoder.trunk.layer{0,1}
#                    x_mean.0               -> decoder.x_mean.layer0
#                    x_logvar.0 | x_std.0   -> decoder.x_logvar.layer0
#                    W / b                  -> W / b
#                    logits.0               -> logits_lin
#   flow             seq_encoder.{0,2,4}    -> encoder.layer{0,1,2}
#                    seq_decoder.{0,2,4,6}  -> decoder.trunk.layer{0..3}
#                    decoder_mean.0         -> decoder.mean.layer0
#                    decoder_logvar.0       -> decoder.logvar.layer0
# (reference: src/models/VAE.py:366-379, 687-708, 2342-2368, 2706-2741,
# 2865-2931, 3026-3041, 1882-1916). torch's Linear weight is [out, in], the
# port's [in, out]: every weight transposes.

#: reference tensors registered but read on no live path: the flow's dead
#: encoder heads and spline pdfs (VAE.py:1792-1793, 1892-1893) and the
#: registered prior constants
_FLOW_DEAD = ("encoder_mean", "encoder_logvar", "flows.", "flow.", "prior_")


def _linear(sd, prefix):
    """One torch nn.Linear -> dense params (weight transposed)."""
    return {"w": _np(sd[f"{prefix}.weight"]).T, "b": _np(sd[f"{prefix}.bias"])}


def _seq_mlp(sd, prefix):
    """A torch nn.Sequential of Linears (+activations) -> mlp_init layout:
    the Linears' Sequential indices (0, 2, 4, ...) become layer0, layer1,
    ..."""
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


def _convert_miwae(sd, cfg):
    del cfg
    return {"encoder": _seq_mlp(sd, "seq_encoder"),
            "decoder": _seq_mlp(sd, "seq_decoder")}


def _convert_notmiwae(sd, cfg):
    del cfg
    # the author variant names its observation head x_std (a softplus std);
    # the port computes logvar = log(std^2) from the same Linear, so its
    # weights fill the x_logvar slot either way (VAE.py:2889, 2924-2928)
    head = "x_std" if "x_std.0.weight" in sd else "x_logvar"
    params = {
        "encoder": {
            "trunk": _seq_mlp(sd, "seq_encoder"),
            "q_mu": _seq_mlp(sd, "q_mu"),
            "q_logstd": _seq_mlp(sd, "q_logstd"),
        },
        "decoder": {
            "trunk": _seq_mlp(sd, "seq_decoder"),
            "x_mean": _seq_mlp(sd, "x_mean"),
            "x_logvar": _seq_mlp(sd, head),
        },
        "W": _np(sd["W"]),
        "b": _np(sd["b"]),
    }
    # the 'linear' missing process: self.logits = nn.Sequential(nn.Linear(D,
    # D)) (VAE.py:2176, 2371, 2552)
    if "logits.0.weight" in sd:
        params["logits_lin"] = _linear(sd, "logits.0")
    return params


def _convert_flow(sd, cfg):
    del cfg
    skipped = [k for k in sd if k.startswith(_FLOW_DEAD)]
    if skipped:
        print(f"note: skipping {len(skipped)} dead reference params "
              f"(unused on any live path): {sorted(skipped)[:4]}...")
    return {
        "encoder": _seq_mlp(sd, "seq_encoder"),
        "decoder": {
            "trunk": _seq_mlp(sd, "seq_decoder"),
            "mean": _seq_mlp(sd, "decoder_mean"),
            "logvar": _seq_mlp(sd, "decoder_logvar"),
        },
    }


_CONVERTERS = {
    "gauss": _convert_gauss,
    "miwae": _convert_miwae,
    "notmiwae": _convert_notmiwae,
    "flow": _convert_flow,
}


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
    """Reference torch state_dict of any family -> nested dict of numpy
    arrays in the JAX/port layout, as the JAX package's
    `tools/convert_reference_checkpoint.py` maps it. Raises ValueError on a
    tensor the mapping does not read (other than the registered dead
    ones), on a shape that differs from the model's and on a leaf the model
    does not have. A leaf the state_dict lacks (a never-trained one, as
    notMIWAE's `logits_lin` under 'selfmasking', or the flow's ActNorm) is
    taken from a fresh init seeded with 0, with a notice."""
    model = get_model(cfg)
    sd = _TrackedDict(sd)
    params = _CONVERTERS[model.name](sd, cfg)
    dead = _FLOW_DEAD if model.name == "flow" else ("prior_",)
    unconsumed = [k for k in sd
                  if k not in sd.consumed and not k.startswith(dead)]
    if unconsumed:
        raise ValueError(
            "reference state_dict tensors not consumed by the converter "
            f"(key-mapping gap, trained weights would be dropped): "
            f"{sorted(unconsumed)}")
    template = flatten(model.init(torch.Generator().manual_seed(0), cfg,
                                  obs_dim, device="cpu"))
    got = flatten(params)
    for key, leaf in template.items():
        if key in got and got[key].shape != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {key}: converted "
                             f"{got[key].shape} vs model {tuple(leaf.shape)}")
    missing = [k for k in template if k not in got]
    if missing:
        print(f"note: {len(missing)} leaves not in the reference checkpoint, "
              f"kept at fresh init: {missing}")
    extra = [k for k in got if k not in template]
    if extra:
        raise ValueError(f"converted leaves unknown to the model: {extra}")
    if missing:
        params = unflatten({k: got[k] if k in got else _np(leaf)
                            for k, leaf in template.items()})
    return params


def _tensor(leaf) -> torch.Tensor:
    """A leaf as a float32 CPU tensor of its own memory."""
    return torch.from_numpy(_np(leaf).copy())


def _rev_linear(sd, prefix, leaf):
    sd[f"{prefix}.weight"] = _tensor(_np(leaf["w"]).T)
    sd[f"{prefix}.bias"] = _tensor(leaf["b"])


def _rev_seq_mlp(sd, prefix, tree):
    # a reference Sequential puts one activation after each Linear, so
    # Linear j sits at index 2j in every class (VAE.py:366-376, 687-698,
    # 2342-2368, 3026-3041, 1882-1916)
    for j in range(len(tree)):
        _rev_linear(sd, f"{prefix}.{2 * j}", tree[f"layer{j}"])


def export_state_dict(params, cfg: RunConfig, obs_dim: int) -> dict:
    """The port's parameters (tensors or numpy arrays) -> a reference-named
    torch state_dict, the inverse of `convert_state_dict`, tensor for
    tensor what the JAX package's tool exports: CPU float32 tensors, every
    weight [out, in], and the registered tensors the reference reads on no
    live path (the flow's dead heads, spline pdfs and prior) at their
    defaults, so the reference's classes load it with strict=True. A
    regularised notMIWAE's `logits.0.*` are float64, as the reference
    registers them (`.double()`)."""
    del obs_dim
    model = get_model(cfg)
    sd = {}
    if model.name == "gauss":
        enc = params["encoder"]
        if "pnp1" in enc:
            _rev_seq_mlp(sd, "pnp_encoder1", enc["pnp1"])
            _rev_seq_mlp(sd, "pnp_encoder2", enc["pnp2"])
            sd["type_pars1"] = _tensor(enc["type_pars"])
            sd["type_bias1"] = _tensor(enc["type_bias"])
        else:
            _rev_seq_mlp(sd, "seq_encoder", enc)
        _rev_seq_mlp(sd, "seq_decoder", params["decoder"])
    elif model.name == "miwae":
        _rev_seq_mlp(sd, "seq_encoder", params["encoder"])
        _rev_seq_mlp(sd, "seq_decoder", params["decoder"])
    elif model.name == "notmiwae":
        _rev_seq_mlp(sd, "seq_encoder", params["encoder"]["trunk"])
        _rev_seq_mlp(sd, "q_mu", params["encoder"]["q_mu"])
        _rev_seq_mlp(sd, "q_logstd", params["encoder"]["q_logstd"])
        _rev_seq_mlp(sd, "seq_decoder", params["decoder"]["trunk"])
        _rev_seq_mlp(sd, "x_mean", params["decoder"]["x_mean"])
        # the author variant names its observation head x_std (VAE.py:2889)
        head = "x_std" if cfg.not_miwae_type == "author" else "x_logvar"
        _rev_seq_mlp(sd, head, params["decoder"]["x_logvar"])
        sd["W"] = _tensor(params["W"])
        sd["b"] = _tensor(params["b"])
        if cfg.info.regularized:
            # the regularised classes register logits whatever the missing
            # process, as float64 (VAE.py:2176, 2371, 2552)
            _rev_linear(sd, "logits.0", params["logits_lin"])
            sd["logits.0.weight"] = sd["logits.0.weight"].double()
            sd["logits.0.bias"] = sd["logits.0.bias"].double()
    else:  # flow
        _rev_seq_mlp(sd, "seq_encoder", params["encoder"])
        _rev_seq_mlp(sd, "seq_decoder", params["decoder"]["trunk"])
        _rev_seq_mlp(sd, "decoder_mean", params["decoder"]["mean"])
        _rev_seq_mlp(sd, "decoder_logvar", params["decoder"]["logvar"])
        # registered but dead (VAE.py:1892-1893, 1822-1825, 1919-1920)
        L, H = cfg.latent_dim, cfg.hid_dim
        sd["encoder_mean.weight"] = torch.zeros(L, H)
        sd["encoder_mean.bias"] = torch.zeros(L)
        sd["encoder_logvar.weight"] = torch.zeros(L, H)
        sd["encoder_logvar.bias"] = torch.zeros(L)
        for i in range(3):
            sd[f"flows.{i}.unnormalized_pdf"] = torch.zeros(L, 10)
        sd["prior_mean"] = torch.zeros(L)
        sd["prior_std"] = torch.ones(L)
    return sd


def load_reference(path: str, cfg: RunConfig, obs_dim: int,
                   device="cuda") -> dict:
    """Read a trained reference state_dict and return the port's params."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return params_from_jax(flatten(convert_state_dict(sd, cfg, obs_dim)),
                           device)

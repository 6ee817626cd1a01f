"""Run configuration: the `vae_type` master switch, `RunConfig` and the
JSONL/argparse layer the entry points read.

A copy of the JAX package's `config.py` contract: every config record of
`Data/imputation_args.json` maps arg-name -> {type, default, help} and becomes
an argparse parser whose single-dash flags override the record (reference:
src/utils/utils.py:177-189). The flags the JAX package adds (`-mesh`,
`-ensemble`, `-seeds`, `-alphas`, `-missings`, `-checkpoint_every`,
`-resume`, `-early_stop`, `-profile`, and `-bdmc` for the `ais_eval`
parser) parse the same way here. `-mesh` resolves as the JAX package
resolves it (`mesh_shape`, `resolve_mesh`): '' and a one-device 'auto' are
the single-device engine, 'DP' or 'DP,TP' a mesh over the ranks of the
process group, which every path of every entry point runs on; the entry
points refuse a spec no device count satisfies (`mesh_shape`'s ValueError)
before anything runs.
The port adds one flag of its own, `-device` (its default
`set_default_device`'s, `cuda` unless VPC_PLATFORM says otherwise). The
ensemble flags reach every entry point's ensembles; `restrict_grid_records`
is their `-vae_type` rule, and `maybe_profile` wraps a run in a trace under
`-profile DIR`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
from typing import Any, Iterator


def str2bool(v: Any) -> bool:
    """Lenient bool parsing (reference: src/utils/utils.py:165-173)."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("yes", "true", "t", "y", "1"):
        return True
    if s in ("no", "false", "f", "n", "0", ""):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


#: flags every parser gets when its record does not define them (the JAX
#: package's framework extensions, and the port's `-device`):
#: name -> (type, default, help)
_EXTRA_FLAGS = {
    "mesh": (str, "", "device mesh: '' = single-device engine; 'auto' = all "
             "ranks, (dp, tp) auto-factored; 'DP' or 'DP,TP' = explicit "
             "split (the process group's world size must equal DP*TP)"),
    "ensemble": (str2bool, False, "train each family's split triple as one "
                 "ensemble"),
    "seeds": (int, 1, "seed replicas per config"),
    "alphas": (str, "", "comma-separated regularization strengths to sweep "
               "(e.g. '0.5,1,2'); empty = the entry's default sweep"),
    "missings": (str, "", "comma-separated p_missingness rates to sweep "
                 "(e.g. '10,30,50'); empty = the entry's default sweep"),
    "checkpoint_every": (int, 0, "write a mid-training .resume.pt every N "
                         "epochs (0 = end-of-training save only, the "
                         "reference behavior)"),
    "resume": (str2bool, False, "restart from the .resume.pt written by a "
               "prior -checkpoint_every run"),
    "early_stop": (str2bool, False, "enable patience-based early stopping "
                   "(cfg.patience counts chunk-boundary validation checks, "
                   "one per 200 epochs; stops on plateau and keeps the "
                   "best-check parameters)"),
    "profile": (str, "", "write a torch.profiler trace of the run to this "
                "directory, the program's own spans and counters (category "
                "'vpc') on its timeline (Chrome trace format; meant for "
                "short runs)"),
    "device": (str, "cuda", "torch device the run uses: 'cuda' (the "
               "kernels) or 'cpu' (their plain versions)"),
}

def set_default_device(device: str) -> None:
    """Make `device` the default of the `-device` flag of every parser
    built from now on (`utils/debugging.apply_platform_from_env`)."""
    typ, _, help_ = _EXTRA_FLAGS["device"]
    _EXTRA_FLAGS["device"] = (typ, device, help_)


def setup_parser(arguments: dict, title: str) -> argparse.ArgumentParser:
    """An argparse parser from a JSONL config record: every key becomes a
    single-dash flag `-<name>` typed after its default, so CLI flags
    override any config value (reference: src/utils/utils.py:177-189); then
    the flags of `_EXTRA_FLAGS` the record does not define."""
    parser = argparse.ArgumentParser(
        description=title, formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    for key, value in arguments.items():
        default = value["default"]
        typ = str2bool if isinstance(default, bool) else type(default)
        parser.add_argument(
            "-%s" % key, type=typ, help=value.get("help", ""), default=default
        )
    for key, (typ, default, help_) in _EXTRA_FLAGS.items():
        if key not in arguments:
            parser.add_argument("-%s" % key, type=typ, default=default,
                                help=help_)
    if title == "ais_eval" and "bdmc" not in arguments:
        # the BDMC sandwich (engine/ais.eval_bdmc), as the JAX package's
        # ais_eval parser has it
        parser.add_argument(
            "-bdmc", type=str2bool, default=False,
            help="also run the BDMC lower/upper sandwich on simulated data "
                 "to certify the AIS schedule (forward + reverse AIS)")
    return parser


def iter_jsonl_configs(path: str) -> Iterator[dict]:
    """Yield per-run config records from a JSON-lines file, skipping blanks."""
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            yield json.loads(line)


# ---------------------------------------------------------------------------
# vae_type string contract
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Typed run config
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunConfig:
    """One experiment run. Field names, order and defaults are the JAX
    package's `RunConfig` (the reference JSONL schema; record 1 of
    Data/imputation_args.json is `reg_MIWAE1`, the flagship `reg_vae1` is
    record 34). Every field parses and is stored; the knobs of families the
    port has not ported yet (flow, (not)MIWAE, AIS) mean nothing until
    those families arrive."""

    missing_rate: int = 50
    vae_type: str = "reg_vae1"
    experiment_type: str = "UCI_experiments_consistency_missingness"
    reg_type: str = "kl_reg"  # 'kl_reg' | 'ml_reg'
    data_type: str = "wine"
    epoch: int = 3000
    batch_size: int = 64
    patience: int = 100
    data_path: str = "Data"
    K: int = 10  # PointNet feature-map dim
    M: int = 1  # Monte-Carlo reps of evaluation
    latent_dim: int = 10
    hid_dim: int = 500
    train_k: int = 20  # IWAE samples during training
    valid_k: int = 5000  # IWAE samples during validation
    n_iwae: int = 50
    n_ais_iwae: int = 40
    ais_schedule: str = "sigmoidal"
    n_ais_dist: int = 500
    num_estimates: int = 100
    beta_annealing: bool = False
    alpha_annealing: bool = True
    # sweep-level knobs (the reference hard-codes these loops:
    # imputation.py:23-24)
    alpha: float = 1.0
    p_missingness: int = 30
    beta: float = 1.0
    seed: int = 0
    data_transform: str = "minmax"  # 'minmax' | 'stand'
    not_miwae_type: str = "changed"  # 'changed' | 'author'
    #: the JAX package's PRNG implementation; stored, unused by the port,
    #: whose noise comes from torch.Generator objects
    rng_impl: str = "rbg"
    flow_tails: str = "clamp"  # 'clamp' | 'linear'
    flow_actnorm: bool = False
    fixed_iwae_bound: bool = False
    reg_notmiwae_variant: str = "v2"  # 'v2' | 'both_s' | 'sampled_mask'
    #: 'float32' (the default every parity test pins) | 'bfloat16' (bf16
    #: operands of the dense products with float32 accumulation, the EDDI
    #: embed held in bf16 on the CPU; parameters and optimizer state stay
    #: float32: models/registry.get_model, nn/core.compute_dtype)
    compute_dtype: str = "float32"
    #: '' | 'auto' | 'DP' | 'DP,TP' (`resolve_mesh`)
    mesh: str = ""

    @property
    def info(self) -> VaeTypeInfo:
        return parse_vae_type(self.vae_type)

    @classmethod
    def from_args(cls, args: argparse.Namespace, **overrides) -> "RunConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in vars(args).items() if k in fields}
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def from_jsonl_record(cls, record: dict, **overrides) -> "RunConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for key, value in record.items():
            if key in fields:
                default = value["default"]
                if isinstance(getattr(cls, key, None), bool) or key.endswith(
                    "_annealing"
                ):
                    default = str2bool(default)
                kw[key] = default
        kw.update(overrides)
        return cls(**kw)

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# CLI flag readers shared by the entry points
# ---------------------------------------------------------------------------


def device_count() -> int:
    """The devices a mesh may span: the world size of the default process
    group (one process a device), 1 when there is none."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def mesh_shape(spec: str, n_devices: int):
    """The rule of the JAX package's `resolve_mesh` (config.py:359-386)
    without the building: '' -> None; 'auto' -> None under 2 devices, else
    `parallel/mesh.factor_devices(n_devices)`; 'DP' or 'DP,TP' -> (dp, tp),
    ValueError with JAX's message when it needs more devices than there
    are, and the ValueError of `int()` for a spec that is not integers.
    One divergence: JAX takes the first DP*TP devices and leaves the rest
    idle, but a rank of a torch process group cannot be left out, so a
    world larger than DP*TP raises ValueError too."""
    from vae_posterior_consistency_tpu_torch.parallel.mesh import (
        factor_devices,
    )

    norm = (spec or "").strip().lower()
    if not norm:
        return None
    if norm == "auto":
        return None if n_devices < 2 else factor_devices(n_devices)
    parts = [int(p) for p in norm.split(",")]
    dp, tp = (parts + [1])[:2]
    need = dp * tp
    if n_devices < need:
        raise ValueError(
            f"-mesh {spec!r} needs {need} devices, have {n_devices}")
    if n_devices > need:
        raise ValueError(
            f"-mesh {spec!r} spans {need} devices but the process group has "
            f"{n_devices} ranks: start one rank a device of the mesh")
    return dp, tp


def resolve_mesh(cfg: "RunConfig", device=None):
    """cfg.mesh -> a `parallel/mesh.Mesh` over the process group's ranks,
    or None (the single-device engine), by `mesh_shape`'s rule. A mesh of
    one device with no process group (a plain `python` run, as JAX builds
    one) first makes a world-size-1 group on a file store in a temporary
    directory, with `device`'s backend. `device` defaults to the `-device`
    flag's default."""
    shape = mesh_shape(cfg.mesh, device_count())
    if shape is None:
        return None
    from vae_posterior_consistency_tpu_torch.parallel import mesh as meshlib
    from vae_posterior_consistency_tpu_torch.parallel import multihost

    device = _EXTRA_FLAGS["device"][1] if device is None else device
    multihost.ensure_group(device)
    return meshlib.make_mesh(dp=shape[0], tp=shape[1], device=device)


def maybe_profile(args):
    """A context manager: under `-profile DIR` a `utils/logging.
    profile_trace` into DIR (the card's activity too when `-device` is a
    CUDA device, and the program's spans and counters, `utils/tracing`),
    announced by the JAX package's line; else a no-op."""
    spec = getattr(args, "profile", "") or ""
    if not spec:
        return contextlib.nullcontext()
    from vae_posterior_consistency_tpu_torch.utils.logging import (
        profile_trace,
    )

    print(f"[profile] tracing to {spec}", flush=True)
    return profile_trace(spec, getattr(args, "device", "cpu"))


def restart_opts(args):
    """(-checkpoint_every, -resume) -> `train`'s (checkpoint_every or None,
    resume), read as the JAX package reads them: a non-positive
    checkpoint_every is 'off'."""
    ck = int(getattr(args, "checkpoint_every", 0) or 0)
    return (ck if ck > 0 else None), bool(getattr(args, "resume", False))


def restrict_grid_records(records, probe):
    """The `-vae_type` rule of every `-ensemble true` path (the JAX
    package's config.py:420-440): the grid is cut to the record of that
    vae_type, where the serial grids apply the override to every record.
    A `-vae_type` equal to the first record's own default cannot be told
    from no flag and keeps the whole grid. Raises SystemExit for a
    vae_type no record has."""
    if probe.vae_type == records[0]["vae_type"]["default"]:
        return records
    matching = [r for r in records
                if r["vae_type"]["default"] == probe.vae_type]
    if not matching:
        raise SystemExit(
            f"-ensemble true cannot apply -vae_type {probe.vae_type!r}: "
            "not a grid record — run without -ensemble to drive a custom "
            "single config")
    print(f"[ensemble mode] -vae_type {probe.vae_type}: grid restricted "
          f"to its record", flush=True)
    return matching


def early_stopper(args, cfg: RunConfig, ensemble: bool = False):
    """`-early_stop` -> a fresh tracker at cfg.patience, verbose, or None
    when unset, as in the JAX package (a fresh tracker per call: patience
    never carries from one record to the next): `EarlyStopping`, or with
    `ensemble` the per-replica `EnsembleEarlyStopping`."""
    if not bool(getattr(args, "early_stop", False)):
        return None
    from vae_posterior_consistency_tpu_torch.utils.early_stopping import (
        EarlyStopping,
        EnsembleEarlyStopping,
    )

    if ensemble:
        return EnsembleEarlyStopping(patience=cfg.patience, verbose=True)
    return EarlyStopping(patience=cfg.patience, verbose=True)


def parse_alphas(args, default):
    """Resolve the `-alphas` flag into a list of floats (the entry's
    hard-coded sweep when unset). Rejects empties/garbage loudly."""
    spec = (getattr(args, "alphas", "") or "").strip()
    if not spec:
        return list(default)
    try:
        alphas = [float(tok) for tok in spec.split(",") if tok.strip()]
    except ValueError:
        raise SystemExit(f"-alphas {spec!r}: expected comma-separated floats")
    if not alphas:
        raise SystemExit(f"-alphas {spec!r}: no values")
    return alphas


def parse_missings(args, default):
    """Resolve the `-missings` flag into a list of ints (the entry's
    hard-coded p_missingness sweep when unset): integer percentages, as the
    reference's `for missing in [30]` loop and the artifact names have them
    (reference: src/experiment_main/imputation.py:23)."""
    spec = (getattr(args, "missings", "") or "").strip()
    if not spec:
        return list(default)
    try:
        vals = [int(tok) for tok in spec.split(",") if tok.strip()]
    except ValueError:
        raise SystemExit(f"-missings {spec!r}: expected comma-separated ints")
    if not vals:
        raise SystemExit(f"-missings {spec!r}: no values")
    return vals

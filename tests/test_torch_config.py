"""Port config and registry against the JAX package: the vae_type master
switch parses identically, RunConfig has the JAX fields and defaults, the
JSONL/argparse layer reads every grid record and every CLI override as JAX
does, the flags whose engine the port lacks raise naming their slice, and
get_model routes the gauss families and refuses the rest by name."""

import argparse
import contextlib
import dataclasses
import json

import pytest

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.models import get_model

GRID = "Data/imputation_args.json"
RECORDS = list(jcfg.iter_jsonl_configs(GRID))

#: the vae_types of tests/test_registry.py, plus its fallback and
#: first-digit cases
VAE_TYPES = [
    "reg_vae1", "reg_vae2_mask_augm", "vanilla_vae3", "vanilla_vae1_mask_augm",
    "vanilla_vae2_with_drop", "vanilla_vae1_with_drop_mask_augm", "reg_EDDI1",
    "vanilla_EDDI2", "vanilla_EDDI3_with_drop", "reg_EDDI_mnist1",
    "vanilla_EDDI_mnist1", "reg_flow1", "vanilla_flow2", "reg_notMIWAE1",
    "vanilla_notMIWAE1", "reg_MIWAE3", "vanilla_MIWAE1", "mystery_model7",
    "reg_vae12",
]


def _check_mesh(args):
    """The check every entry point makes of its flags before it runs:
    `mesh_shape`'s ValueError for a -mesh no device count satisfies."""
    tcfg.mesh_shape(args.mesh, tcfg.device_count())


@pytest.mark.parametrize("vae_type", VAE_TYPES)
def test_parse_vae_type_matches_jax(vae_type):
    got = dataclasses.asdict(tcfg.parse_vae_type(vae_type))
    want = dataclasses.asdict(jcfg.parse_vae_type(vae_type))
    assert got == want


def test_family_precedence_matches_jax():
    assert tcfg.FAMILY_PRECEDENCE == jcfg.FAMILY_PRECEDENCE


def test_run_config_defaults_match_jax():
    port = tcfg.RunConfig()
    ref = jcfg.RunConfig()
    assert ([f.name for f in dataclasses.fields(port)]
            == [f.name for f in dataclasses.fields(ref)])
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.M == 1
    assert port.info == tcfg.parse_vae_type(ref.vae_type)


@pytest.mark.parametrize("value", [True, False, "yes", "True", " t ", "Y",
                                   "1", "no", "FALSE", "f", "n", "0", "", " ",
                                   1, 0, "maybe", "2"])
def test_str2bool_matches_jax(value):
    try:
        want = jcfg.str2bool(value)
    except argparse.ArgumentTypeError:
        with pytest.raises(argparse.ArgumentTypeError):
            tcfg.str2bool(value)
        return
    assert tcfg.str2bool(value) is want


def test_iter_jsonl_configs_matches_jax(tmp_path):
    path = tmp_path / "grid.json"
    path.write_text("\n" + json.dumps({"a": {"default": 1}}) + "\n\n"
                    + json.dumps({"b": {"default": "x"}}) + "\n")
    assert (list(tcfg.iter_jsonl_configs(str(path)))
            == list(jcfg.iter_jsonl_configs(str(path))))
    assert len(list(tcfg.iter_jsonl_configs(GRID))) == len(RECORDS) == 39


def _parsed(cfg_mod, record, argv):
    args = cfg_mod.setup_parser(record, "impute_eval").parse_args(argv)
    return args, cfg_mod.RunConfig.from_args(args, alpha=1.0,
                                             p_missingness=30)


#: CLI overrides as a user passes them, applied to every record
ARGVS = [
    [],
    ["-vae_type", "reg_vae1", "-epoch", "2"],
    ["-M", "7", "-batch_size", "16", "-beta_annealing", "true",
     "-missing_rate", "50"],
    ["-alphas", "0.5,2", "-missings", "10,30", "-seeds", "1", "-mesh", ""],
]


@pytest.mark.parametrize("index", range(len(RECORDS)))
@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "none")
def test_every_grid_record_parses_as_in_jax(index, argv):
    record = RECORDS[index]
    t_args, t_cfg = _parsed(tcfg, record, argv)
    j_args, j_cfg = _parsed(jcfg, record, argv)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    shared = set(vars(j_args)) - {"profile"}
    assert {k: getattr(t_args, k) for k in shared} == {
        k: getattr(j_args, k) for k in shared}
    assert set(vars(t_args)) == set(vars(j_args)) | {"device"}
    assert t_args.device == "cuda"
    via_record = tcfg.RunConfig.from_jsonl_record(record)
    assert dataclasses.asdict(via_record) == dataclasses.asdict(
        jcfg.RunConfig.from_jsonl_record(record))


def test_from_jsonl_record_reads_bools_as_jax_does():
    record = {"vae_type": {"default": "reg_vae2"},
              "beta_annealing": {"default": " "},
              "alpha_annealing": {"default": "false"},
              "flow_actnorm": {"default": "yes"},
              "not_a_field": {"default": 3}}
    got = tcfg.RunConfig.from_jsonl_record(record, seed=4)
    want = jcfg.RunConfig.from_jsonl_record(record, seed=4)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.beta_annealing is False and got.flow_actnorm is True
    assert got.replace(M=3).M == 3 and got.M == 1
    assert dataclasses.asdict(got.replace(epoch=5)) == dataclasses.asdict(
        want.replace(epoch=5))


@pytest.mark.parametrize("spec", ["", "1", "0.5,1,2", " 2 , 3 ", "1,,2",
                                  "a,b", ",", "1e-1"])
def test_parse_alphas_and_missings_match_jax(spec):
    args = argparse.Namespace(alphas=spec, missings=spec)
    for name in ("parse_alphas", "parse_missings"):
        default = [1.0] if name == "parse_alphas" else [30]
        try:
            want = getattr(jcfg, name)(args, default)
        except SystemExit as exc:
            with pytest.raises(SystemExit) as got:
                getattr(tcfg, name)(args, default)
            assert str(got.value) == str(exc)
            continue
        assert getattr(tcfg, name)(args, default) == want


def test_restart_and_early_stop_flags_parse_as_jax_and_wait_for_slice_5():
    """Slice 5 is in: the flags read as the JAX package reads them, and
    -early_stop gives a fresh EarlyStopping at the record's patience."""
    from vae_posterior_consistency_tpu_torch.utils.early_stopping import (
        EarlyStopping,
    )

    probe = tcfg.setup_parser(RECORDS[33], "impute_eval").parse_args([])
    assert tcfg.restart_opts(probe) == jcfg.restart_opts(probe) == (None,
                                                                   False)
    assert tcfg.early_stopper(probe, tcfg.RunConfig()) is None
    for argv, want in ((["-checkpoint_every", "5"], (5, False)),
                       (["-resume", "true"], (None, True)),
                       (["-checkpoint_every", "-3"], (None, False))):
        args = tcfg.setup_parser(RECORDS[33], "x").parse_args(argv)
        assert tcfg.restart_opts(args) == jcfg.restart_opts(args) == want
    args = tcfg.setup_parser(RECORDS[33], "x").parse_args(
        ["-early_stop", "yes", "-patience", "7"])
    cfg = tcfg.RunConfig.from_args(args)
    got, want = tcfg.early_stopper(args, cfg), jcfg.early_stopper(
        args, jcfg.RunConfig.from_args(args))
    assert isinstance(got, EarlyStopping)
    assert (got.patience, got.verbose, got.delta, got.path) == (
        want.patience, want.verbose, want.delta, want.path) == (7, True, 0.0,
                                                                None)
    assert tcfg.early_stopper(args, cfg) is not got
    # slice 9 is in too: an ensemble gets the per-replica tracker
    ens = tcfg.early_stopper(args, cfg, ensemble=True)
    assert type(ens).__name__ == "EnsembleEarlyStopping"
    assert (ens.patience, ens.verbose) == (7, True)


def test_bdmc_flag_is_ais_entry_only():
    """-bdmc belongs to the ais_eval parser alone, as in the JAX package."""
    record = {"vae_type": {"default": "vanilla_vae1", "help": ""}}
    for pkg in (tcfg, jcfg):
        assert pkg.setup_parser(record, "ais_eval").parse_args(
            ["-bdmc", "true"]).bdmc is True
        assert pkg.setup_parser(record, "ais_eval").parse_args([]).bdmc is False
        assert not hasattr(pkg.setup_parser(record, "impute_eval").parse_args(
            []), "bdmc")


@pytest.mark.parametrize("argv,refusal", [
    # -mesh resolves as in JAX: 'auto' on one device is the single-device
    # engine, '2,1' needs two devices (JAX's ValueError and message)
    (["-mesh", "auto"], None),
    (["-mesh", "2,1"], (ValueError, "needs 2 devices, have 1")),
    # a mesh beside the ensemble flags runs since slice 10 part 2
    (["-mesh", "1,1", "-seeds", "4"], None),
    # ported since: every entry point has its ensembles and -profile
    (["-ensemble", "true"], None), (["-seeds", "4"], None),
    (["-profile", "traces"], None)])
def test_unported_flags_name_their_slice(argv, refusal):
    """An entry point refuses a -mesh no device count satisfies (JAX's
    ValueError); a resolved mesh beside the ensemble flags and the flags
    ported since pass, and -profile makes `maybe_profile` a trace."""
    args = tcfg.setup_parser(RECORDS[33], "impute_eval").parse_args(argv)
    if refusal is None:
        _check_mesh(args)
        traced = not isinstance(tcfg.maybe_profile(args),
                                contextlib.nullcontext)
        assert traced == (argv[0] == "-profile")
        return
    with pytest.raises(refusal[0], match=refusal[1]):
        _check_mesh(args)


def test_ported_flags_pass():
    args = tcfg.setup_parser(RECORDS[33], "impute_eval").parse_args(
        ["-mesh", " ", "-seeds", "1", "-ensemble", "no", "-device", "cpu"])
    _check_mesh(args)
    assert args.device == "cpu"


@pytest.mark.parametrize("vae_type,regularized", [
    ("reg_vae1", True), ("vanilla_vae1", False), ("reg_EDDI1", True),
    ("vanilla_EDDI2", False)])
def test_get_model_routes_gauss(vae_type, regularized):
    model = get_model(tcfg.RunConfig(vae_type=vae_type))
    assert model.name == "gauss"
    assert model.uses_p_branch is regularized
    assert model.eval_kind == "vae"


@pytest.mark.parametrize("vae_type,regularized", [
    ("reg_flow1", True), ("reg_flow3", True), ("vanilla_flow2", False)])
def test_get_model_routes_flow(vae_type, regularized):
    model = get_model(tcfg.RunConfig(vae_type=vae_type))
    assert model.name == "flow"
    assert model.uses_p_branch is regularized
    assert model.eval_kind == "vae"
    assert model.encode_sample_logprob is not None


@pytest.mark.parametrize("vae_type,slice_name", [
    ("reg_notMIWAE1", "slice 7, the importance-weighted"),
    ("MIWAE1", "importance-weighted"),
    ("reg_MIWAE1", "slice 7, the importance-weighted"),
    ("vanilla_notMIWAE1", "importance-weighted")])
def test_get_model_names_the_slice_of_unported_families(vae_type, slice_name):
    """The importance-weighted families, once refused here naming their
    slice (`slice_name`), now have a model; so has each under
    compute_dtype 'bfloat16', once refused naming the mixed-precision
    slice: the same family with its train_loss and eval_step wrapped."""
    assert "importance-weighted" in slice_name
    model = get_model(tcfg.RunConfig(vae_type=vae_type))
    assert model.name == ("notmiwae" if "notMIWAE" in vae_type else "miwae")
    assert model.eval_kind == "miwae"
    assert model.uses_p_branch is vae_type.startswith("reg_")
    bf16 = get_model(tcfg.RunConfig(vae_type=vae_type,
                                    compute_dtype="bfloat16"))
    assert (bf16.name, bf16.eval_kind, bf16.uses_p_branch) == (
        model.name, model.eval_kind, model.uses_p_branch)
    assert bf16.eval_step.__wrapped__ is model.eval_step


def test_compute_dtype():
    """'bfloat16' gives a model, equal on every call (JAX's memoised
    wrappers); any other spelling raises ValueError, as in JAX."""
    cfg = tcfg.RunConfig(compute_dtype="bfloat16")
    assert get_model(cfg) == get_model(cfg) != get_model(tcfg.RunConfig())
    with pytest.raises(ValueError, match="compute_dtype"):
        get_model(tcfg.RunConfig(compute_dtype="bf16"))

"""The ensemble paths of the port's two imputation entry points against the
JAX package's: each path run by both over the same small grid (synth_small,
1 epoch) writes the same checkpoint, `.seed{s}`, resume-file and artifact
names and prints the same banners; the per-replica early stopper reaches
the ensembles; `restrict_grid_records` cuts an ensemble grid to one record;
and the mesh check every entry point makes lets the ensemble flags
through."""

import os
import shutil

import numpy as np
import pytest

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.experiment_main import (
    imputation,
    imputation_mnar,
)
from vae_posterior_consistency_tpu_torch.parallel import sweep as tsweep
from vae_posterior_consistency_tpu_torch.utils import early_stopping as tes
from cli_harness import REPO, grid_record

#: small records of the grid's shape: synth_small (120 rows of 6) at 1
#: epoch (what is compared, the names written and the banners, does not
#: depend on the epochs), narrow and with few importance samples
BASE = dict(data_type="synth_small", epoch=1, batch_size=16, M=1, train_k=2,
            valid_k=3, latent_dim=4, missing_rate=30, hid_dim=32)
MCAR_RECORDS = [grid_record(vae_type=f"{fam}{i}", **BASE)
                for fam in ("reg_vae", "vanilla_EDDI") for i in "12"]
MNAR_RECORDS = [grid_record(vae_type=v, **BASE)
                for v in ("reg_notMIWAE1", "vanilla_vae1")]


def _check_mesh(args):
    """The check every entry point makes of its flags before it runs:
    `mesh_shape`'s ValueError for a -mesh no device count satisfies."""
    tcfg.mesh_shape(args.mesh, tcfg.device_count())


def _workdir(path, mcar=MCAR_RECORDS, mnar=MNAR_RECORDS):
    os.makedirs(path / "Data")
    shutil.copytree(os.path.join(REPO, "Data", "synth_small"),
                    path / "Data" / "synth_small")
    (path / "Data" / "imputation_args.json").write_text("\n".join(mcar) + "\n")
    (path / "Data" / "imputation_args_mnar.json").write_text(
        "\n".join(mnar) + "\n")
    return path


def _written(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(os.path.join(root,
                                                          "experiments"))
                  for f in files)


def _run_jax(monkeypatch, workdir, entry, flags):
    """The JAX entry point's grid runner in `workdir`, its parsers reading
    `flags` as they read sys.argv."""
    import importlib

    jmod = importlib.import_module(f"experiment_main.{entry}")
    # the JAX entry points set the PRNG implementation of the records
    # (rbg); this process keeps the tests' threefry
    monkeypatch.setattr(jmod, "apply_rng_impl", lambda cfg: None)
    monkeypatch.setattr("sys.argv", [f"{entry}.py", *flags])
    monkeypatch.chdir(workdir)
    records = list(jcfg.iter_jsonl_configs(os.path.join(
        "Data", "imputation_args.json" if entry == "imputation"
        else "imputation_args_mnar.json")))
    if entry == "imputation":
        jmod._run_grid(records, jcfg.setup_parser(
            records[0], "impute_eval").parse_args())
    else:
        jmod._run_grid(records)


PATHS = {
    "split ensembles, -seeds 2": (
        "imputation", ["-ensemble", "true", "-seeds", "2"]),
    "alpha ensembles, -seeds 2": (
        "imputation", ["-ensemble", "true", "-alphas", "0.5,1.0", "-seeds",
                       "2"]),
    "sweep ensembles": (
        "imputation", ["-ensemble", "true", "-missings", "20,40",
                       "-alphas", "0.5,1.0"]),
    "serial grid, -seeds 2": ("imputation", ["-seeds", "2"]),
    "MNAR -seeds 2": ("imputation_mnar", ["-seeds", "2"]),
    "MNAR -ensemble true": (
        "imputation_mnar", ["-ensemble", "true", "-missings", "20,50",
                            "-seeds", "2"]),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_ensemble_path_writes_the_names_jax_writes(tmp_path, monkeypatch,
                                                   capsys, path):
    """Both packages over the same grid with -checkpoint_every 1: the same
    files under experiments/ (checkpoints with their `.seed{s}` siblings,
    the ensemble's resume file, the artifacts, metrics.jsonl) and the same
    banner lines."""
    entry, flags = PATHS[path]
    flags = [*flags, "-checkpoint_every", "1"]
    port_dir = _workdir(tmp_path / "port")
    jax_dir = _workdir(tmp_path / "jax")
    mod = imputation if entry == "imputation" else imputation_mnar
    monkeypatch.chdir(port_dir)
    assert mod.main(["-device", "cpu", *flags]) == 0
    port_out = capsys.readouterr().out
    _run_jax(monkeypatch, jax_dir, entry, flags)
    jax_out = capsys.readouterr().out
    got, want = _written(port_dir), _written(jax_dir)
    assert got == want
    assert any(".resume.pt" in f for f in got)
    assert any(f.endswith(".seed1") for f in got) == ("-seeds" in flags)
    banners = [ln for ln in jax_out.splitlines()
               if ln.startswith(("===", "[")) and "Devices" not in ln]
    assert banners and banners == [
        ln for ln in port_out.splitlines()
        if ln.startswith(("===", "[")) and "Device" not in ln]
    # every printed metric is finite
    values = [float(tok.split("=")[1].split("±")[0])
              for ln in port_out.splitlines() if ln.startswith("  ")
              for tok in ln.split() if "=" in tok and tok[0] != "["
              and tok.split("=")[0] in ("loss", "negl", "negl_imp", "rmse")]
    assert values and np.isfinite(values).all()


def test_early_stop_reaches_the_ensembles_as_a_per_replica_tracker(
        tmp_path, monkeypatch):
    """-early_stop with -ensemble true hands the split ensemble a fresh
    EnsembleEarlyStopping at the record's patience, as the JAX entry point
    does (config.early_stopper(..., ensemble=True))."""
    monkeypatch.chdir(_workdir(tmp_path, mcar=[
        grid_record(vae_type=f"reg_vae{i}", patience=1, **BASE)
        for i in "12"]))
    real, seen = tsweep.train_split_ensemble, []

    def spy(datasets, cfg, **kw):
        seen.append(kw["early_stopping"])
        return real(datasets, cfg, **kw)

    monkeypatch.setattr(tsweep, "train_split_ensemble", spy)
    assert imputation.main(["-device", "cpu", "-ensemble", "true",
                            "-early_stop", "true"]) == 0
    (es,) = seen
    assert isinstance(es, tes.EnsembleEarlyStopping)
    assert (es.patience, es.verbose) == (1, True)
    assert es.best_loss is not None and es.best_loss.shape == (2,)


def test_early_stopper_matches_jax_for_ensembles():
    record = {"vae_type": {"default": "reg_vae1", "help": ""},
              "patience": {"default": 7, "help": ""}}
    args = tcfg.setup_parser(record, "x").parse_args(["-early_stop", "yes"])
    got = tcfg.early_stopper(args, tcfg.RunConfig.from_args(args),
                             ensemble=True)
    want = jcfg.early_stopper(args, jcfg.RunConfig.from_args(args),
                              ensemble=True)
    assert type(got).__name__ == type(want).__name__ == (
        "EnsembleEarlyStopping")
    assert (got.patience, got.delta, got.verbose) == (
        want.patience, want.delta, want.verbose) == (7, 0.0, True)


@pytest.mark.parametrize("vae_type,want", [
    ("reg_vae1", ["reg_vae1", "reg_vae2", "vanilla_EDDI1", "vanilla_EDDI2"]),
    ("vanilla_EDDI2", ["vanilla_EDDI2"]), ("reg_vae9", None)])
def test_restrict_grid_records_matches_jax(vae_type, want, capsys):
    records = [__import__("json").loads(r) for r in MCAR_RECORDS]
    probe = tcfg.setup_parser(records[0], "impute_eval").parse_args(
        ["-vae_type", vae_type])
    if want is None:
        for pkg in (tcfg, jcfg):
            with pytest.raises(SystemExit, match="not a grid record"):
                pkg.restrict_grid_records(records, probe)
        return
    got = tcfg.restrict_grid_records(records, probe)
    assert got == jcfg.restrict_grid_records(records, probe)
    assert [r["vae_type"]["default"] for r in got] == want
    out = capsys.readouterr().out
    assert ("grid restricted" in out) == (len(want) == 1)


def test_ensemble_vae_type_flag_runs_one_record(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.chdir(_workdir(tmp_path))
    assert imputation.main(["-device", "cpu", "-ensemble", "true",
                            "-vae_type", "vanilla_EDDI2", "-epoch", "1"]) == 0
    out = capsys.readouterr().out
    assert "=== ensemble train ['vanilla_EDDI2'] (missing=30, alpha=1.0) " \
        "===" in out
    assert out.count("=== ensemble train") == 1


@pytest.mark.parametrize("flags", [["-ensemble", "true"], ["-seeds", "2"]])
def test_active_learning_ensemble_flags_still_name_their_slice(flags):
    """The AL entry point's and ais_eval's ensembles came with slice 9 part
    2: the mesh check every entry point makes lets the ensemble
    flags through, in both parsers, and since slice 10 part 2 a mesh beside
    them too."""
    record = {"vae_type": {"default": "reg_vae1", "help": ""}}
    for title in ("impute_eval", "ais_eval"):
        args = tcfg.setup_parser(record, title).parse_args(flags)
        _check_mesh(args)
    # beside them -mesh 'auto' resolves to no mesh on one device and a
    # mesh ('1,1') to one: both pass; '2,1' needs two devices
    for mesh in ("auto", "1,1"):
        _check_mesh(tcfg.setup_parser(record, "impute_eval")
                    .parse_args(flags + ["-mesh", mesh]))
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        _check_mesh(tcfg.setup_parser(record, "impute_eval")
                    .parse_args(flags + ["-mesh", "2,1"]))

"""The port's entry point, `python -m
vae_posterior_consistency_tpu_torch.experiment_main.imputation`, on the CPU:
a one-record grid (record 34, the flagship reg_vae1, cut to 2 epochs; also
record 10, reg_flow1, record 25, vanilla_EDDI1_with_drop, and the MIWAE
records 1, 4 and 6) trains, saves a checkpoint the JAX package reads, and
writes the artifacts under the names the JAX package's entry point gives
them; the full grid names no record; a record asking for compute_dtype
'bfloat16' runs as well, with the same names."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.data import loaders as jloaders
from vae_posterior_consistency_tpu.engine import artifacts as jart
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu.engine import train as jtrain
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.experiment_main import imputation
from vae_posterior_consistency_tpu_torch.models import get_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = [json.loads(line) for line in
           open(os.path.join(REPO, "Data", "imputation_args.json"))
           if line.strip()]
#: 1-based record numbers in Data/imputation_args.json
FLAGSHIP, REG_FLOW, MIWAE, WITH_DROP = 34, 10, 4, 25
#: the records of the MIWAE family, whose evaluator writes the rmse only
MIWAE_RECORDS = list(range(1, 7))


def _record(number, **defaults):
    """A copy of grid record `number` with the given defaults; a field the
    record lacks is added."""
    record = json.loads(json.dumps(RECORDS[number - 1]))
    for key, value in defaults.items():
        record.setdefault(key, {"type": type(value).__name__, "help": ""})
        record[key]["default"] = value
    return record


def _workdir(tmp_path, records):
    """A directory holding Data/imputation_args.json with `records` and a
    copy of Data/wine."""
    os.makedirs(tmp_path / "Data")
    shutil.copytree(os.path.join(REPO, "Data", "wine"),
                    tmp_path / "Data" / "wine")
    with open(tmp_path / "Data" / "imputation_args.json", "w") as fh:
        for rec in records:
            fh.write(json.dumps(rec) + "\n")
    return tmp_path


def test_one_record_grid_trains_evaluates_and_saves_what_jax_reads(
        tmp_path, monkeypatch, capsys):
    record = _record(FLAGSHIP, epoch=2)
    monkeypatch.chdir(_workdir(tmp_path, [record]))
    assert imputation.main(["-device", "cpu"]) == 0
    _check_one_record_run(record, capsys.readouterr().out, ("reg_vae1", 2,
                                                           50, 30))


@pytest.mark.parametrize("number,vae_type", [
    (REG_FLOW, "reg_flow1"), (WITH_DROP, "vanilla_EDDI1_with_drop")])
def test_flow_and_drop_records_write_what_jax_reads(
        tmp_path, monkeypatch, capsys, number, vae_type):
    """Record 10 (the flow posterior, hid_dim 500) and record 25 (the EDDI
    drop mask), each cut to 2 epochs and M=2."""
    record = _record(number, epoch=2, M=2)
    monkeypatch.chdir(_workdir(tmp_path, [record]))
    assert imputation.main(["-device", "cpu"]) == 0
    _check_one_record_run(record, capsys.readouterr().out, (vae_type, 2, 2,
                                                           30))


def test_the_full_grid_names_exactly_records_1_to_6():
    """Records 1-6 (the MIWAE family) were the ones named as not ported,
    then compute_dtype 'bfloat16' was; now every one of the 39 records has
    a model in float32 and in bfloat16, and exactly records 1-6 evaluate
    through the MIWAE evaluator."""
    miwae = []
    for number, record in enumerate(RECORDS, start=1):
        args = imputation.setup_parser(record, "impute_eval").parse_args([])
        cfg = imputation.RunConfig.from_args(args, alpha=1.0,
                                             p_missingness=30)
        model = get_model(cfg)
        bf16 = get_model(cfg.replace(compute_dtype="bfloat16"))
        assert bf16.name == model.name and bf16.eval_kind == model.eval_kind
        assert bf16.train_loss.__wrapped__ is model.train_loss
        if model.eval_kind == "miwae":
            miwae.append(number)
    assert len(RECORDS) == 39
    assert miwae == MIWAE_RECORDS


@pytest.mark.parametrize("number,vae_type", [
    (1, "reg_MIWAE1"), (4, "vanilla_MIWAE1"), (6, "vanilla_MIWAE3")])
def test_a_miwae_record_trains_evaluates_and_saves_what_jax_reads(
        tmp_path, monkeypatch, capsys, number, vae_type):
    """Records 1, 4 and 6 (train_k 20, M=1, missing_rate 50) at 1 epoch and
    valid_k 50: the CPU cannot afford the records' 5000 importance samples
    a row in a test. The checkpoint is read by JAX's load_trained; the
    artifacts are the rmse files at JAX's eval_miwae_paths names."""
    record = _record(number, epoch=1, valid_k=50)
    monkeypatch.chdir(_workdir(tmp_path, [record]))
    assert imputation.main(["-device", "cpu"]) == 0
    _check_one_record_run(record, capsys.readouterr().out, (vae_type, 1, 1,
                                                           50))


def _check_one_record_run(record, out, want_cfg):
    """The output, checkpoint and artifacts of a one-record grid run in
    the working directory: the checkpoint at JAX's path, read by JAX's
    load_trained; JAX's artifact names and nothing else."""
    vae_type, epochs = want_cfg[:2]
    assert f"=== train {vae_type} (missing=30, alpha=1.0) ===" in out
    assert f"Epoch: [{epochs - 1}/{epochs}], Total Loss:" in out  # the last
    for stage in ("train", "test"):
        line = [ln for ln in out.splitlines()
                if ln.startswith(f"  [{stage}] ")]
        assert len(line) == 1
        fields = dict(kv.split("=") for kv in line[0].split()[1:])
        assert list(fields) == ["loss", "negl", "negl_imp", "rmse"]
        assert all(np.isfinite(float(v)) for v in fields.values())

    args = jcfg.setup_parser(record, "impute_eval").parse_args([])
    jc = jcfg.RunConfig.from_args(args, alpha=1.0, p_missingness=30)
    assert (jc.vae_type, jc.epoch, jc.M, jc.missing_rate) == want_cfg
    # the checkpoint: at JAX's path, read by JAX's load_trained
    ckpt = jckpt.checkpoint_path(jc, "experiments")
    assert os.path.isfile(ckpt)
    jds = jloaders.data_loader("Data", jc.vae_type, jc.missing_rate,
                               jc.batch_size, jc.data_type)
    loaded = jckpt._flatten(jtrain.load_trained(jds, jc, "experiments"))
    saved = torch.load(ckpt, weights_only=False)
    assert sorted(loaded) == sorted(saved)
    for key, value in saved.items():
        np.testing.assert_array_equal(loaded[key], value, err_msg=key)
    # the artifacts: JAX's names, nothing else but metrics.jsonl; the MIWAE
    # evaluator writes the rmse only
    paths = (jart.eval_miwae_paths if get_model(imputation.RunConfig.from_args(
        imputation.setup_parser(record, "impute_eval").parse_args([]))
    ).eval_kind == "miwae" else jart.eval_vae_paths)
    want = {ckpt}
    for stage in ("train", "test"):
        want |= set(paths(jc, stage, "experiments").values())
    metrics = os.path.join("experiments", jc.experiment_type, jc.data_type,
                           "metrics.jsonl")
    want.add(metrics)
    written = {os.path.join(d, f) for d, _, files in os.walk("experiments")
               for f in files}
    assert written == want
    for stage in ("train", "test"):
        for path in paths(jc, stage, "experiments").values():
            value = torch.load(path, weights_only=False)
            assert value.dtype == torch.float64 and value.shape == ()
            assert np.isfinite(value.item())
    recs = [json.loads(line) for line in open(metrics)]
    assert [(r["stage"], r["metric"]) for r in recs] == [
        (s, m) for s in ("train", "test")
        for m in ("loss", "negl", "negl_imp", "rmse")]


@pytest.mark.parametrize("number,names", [
    (1, ("reg_MIWAE1", "bfloat16")),
    (MIWAE, ("vanilla_MIWAE1", "bfloat16")),
    (6, ("vanilla_MIWAE3", "bfloat16"))])
def test_an_unported_record_fails_by_name_and_the_exit_is_nonzero(
        tmp_path, monkeypatch, capsys, number, names):
    """Records 1, 4 and 6 asking for compute_dtype 'bfloat16', once named
    and not run, now run (1 epoch, valid_k 50 as above) and exit 0: the
    checkpoint JAX's load_trained reads and the rmse artifacts at JAX's
    names, nothing named as not run."""
    record = _record(number, epoch=1, valid_k=50, compute_dtype=names[1])
    monkeypatch.chdir(_workdir(tmp_path, [record]))
    assert imputation.main(["-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "not run" not in out
    _check_one_record_run(record, out, (names[0], 1, 1, 50))


def test_the_module_runs_from_the_command_line(tmp_path):
    """Record 10 asking for compute_dtype 'bfloat16' beside the flagship,
    each at 1 epoch and M=1: both run and the exit code is 0. `-mesh auto`,
    which resolves to no mesh on one device, runs the same single-device
    engine and prints no mesh tag."""
    work = _workdir(tmp_path, [_record(REG_FLOW, epoch=1, M=1,
                                       compute_dtype="bfloat16"),
                               _record(FLAGSHIP, epoch=1, M=1)])
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m",
           "vae_posterior_consistency_tpu_torch.experiment_main.imputation",
           "-device", "cpu"]
    for run in (cmd, cmd + ["-mesh", "auto"]):
        proc = subprocess.run(run, cwd=work, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        assert "=== train reg_flow1 (missing=30, alpha=1.0) ===" in proc.stdout
        assert "=== train reg_vae1 (missing=30, alpha=1.0) ===" in proc.stdout
        assert proc.stdout.count("  [test] loss=") == 2
        assert "not run" not in proc.stdout
        assert "mesh=" not in proc.stdout and "Traceback" not in proc.stderr


def test_a_missing_grid_raises(tmp_path, monkeypatch):
    """A missing grid no longer raises: the entry point writes the JAX
    package's default grids into Data/ first, as JAX's does, and runs
    (here one record, cut by -vae_type in ensemble mode, 1 epoch)."""
    os.makedirs(tmp_path / "Data")
    shutil.copytree(os.path.join(REPO, "Data", "wine"),
                    tmp_path / "Data" / "wine")
    monkeypatch.chdir(tmp_path)
    assert imputation.main(["-device", "cpu", "-ensemble", "true",
                            "-vae_type", "vanilla_vae1", "-epoch", "1",
                            "-M", "1"]) == 0
    with open(os.path.join("Data", "imputation_args.json")) as fh:
        assert [json.loads(line) for line in fh] == RECORDS
    jc = jcfg.RunConfig.from_jsonl_record(RECORDS[21], epoch=1)
    assert os.path.isfile(jckpt.checkpoint_path(jc, "experiments"))


def test_port_checkpoint_path_is_jax_path_for_every_grid_record():
    for record in RECORDS:
        args = jcfg.setup_parser(record, "impute_eval").parse_args([])
        jc = jcfg.RunConfig.from_args(args, alpha=1.0, p_missingness=30)
        tc = imputation.RunConfig.from_args(
            imputation.setup_parser(record, "impute_eval").parse_args([]),
            alpha=1.0, p_missingness=30)
        assert tckpt.checkpoint_path(tc) == jckpt.checkpoint_path(jc)


def test_restart_and_early_stop_flags_reach_train_on_the_serial_grid(
        tmp_path, monkeypatch):
    """Record 34 at M=2: 2 epochs with -checkpoint_every 1, then 4 epochs
    with -resume true, which goes on from the file's 2 (history of epochs
    3-4 only, the file then at 4); then -early_stop true -patience 1 with
    a fresh EarlyStopping at the record's patience, as the JAX entry point
    passes them (experiment_main/imputation.py:534-550)."""
    from vae_posterior_consistency_tpu_torch.engine import train as ttrain
    from vae_posterior_consistency_tpu_torch.utils.early_stopping import (
        EarlyStopping,
    )

    monkeypatch.chdir(_workdir(tmp_path, [_record(FLAGSHIP, M=2)]))
    real, seen = ttrain.train, []

    def spy(dataset, cfg, **kw):
        params, history = real(dataset, cfg, **kw)
        seen.append((cfg, kw, history))
        return params, history

    monkeypatch.setattr(ttrain, "train", spy)
    for argv in (["-epoch", "2", "-checkpoint_every", "1"],
                 ["-epoch", "4", "-checkpoint_every", "1", "-resume", "true"],
                 ["-epoch", "2", "-early_stop", "true", "-patience", "1"]):
        assert imputation.main(["-device", "cpu", *argv]) == 0
    (c1, k1, h1), (c2, k2, h2), (c3, k3, h3) = seen
    assert (k1["checkpoint_every"], k1["resume"]) == (1, False)
    assert (k2["checkpoint_every"], k2["resume"]) == (1, True)
    assert len(h1) == 2 and len(h2) == 2
    saved = torch.load(tckpt.checkpoint_path(c2, "experiments")
                       + ".resume.pt", weights_only=False)
    assert int(saved["epoch"]) == 4
    assert k1["early_stopping"] is None and k2["early_stopping"] is None
    es = k3["early_stopping"]
    assert isinstance(es, EarlyStopping) and es.patience == 1
    assert es.best_params is not None and len(h3) == 2

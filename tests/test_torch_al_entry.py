"""The port's active-learning entry point, `python -m
vae_posterior_consistency_tpu_torch.experiment_main.active_learning`, on
the CPU: after the imputation entry point trains a one-record grid (record
37, reg_EDDI1, and record 22, vanilla_vae1, each cut to 2 epochs and M=2)
in a temporary directory, it runs one episode a record on the 17 wine test
rows, prints the JAX package's lines, writes the four artifacts at the JAX
package's paths with its shapes and dtypes and appends `al_final_mse`;
it refuses `-mesh`, runs the ensemble flags and stops with the path of a
checkpoint never trained."""

import json
import os
import re

import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.engine import artifacts as jart
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu_torch.experiment_main import (
    active_learning,
    imputation,
)
from test_torch_imputation_entry import _record, _workdir

#: 1-based record numbers in Data/imputation_args.json
REG_EDDI, VANILLA_VAE = 37, 22
#: the wine width and test split's size
D, N = 13, 17


def _trained(tmp_path, monkeypatch, number):
    record = _record(number, epoch=2, M=2)
    monkeypatch.chdir(_workdir(tmp_path, [record]))
    assert imputation.main(["-device", "cpu"]) == 0
    return record


@pytest.mark.parametrize("number", [REG_EDDI, VANILLA_VAE])
def test_one_record_episode_writes_what_jax_writes(tmp_path, monkeypatch,
                                                   capsys, number):
    record = _trained(tmp_path, monkeypatch, number)
    capsys.readouterr()
    assert active_learning.main(["-device", "cpu"]) == 0
    out = capsys.readouterr().out
    vae_type = record["vae_type"]["default"]
    assert f"=== active learning {vae_type} ===" in out
    curve = re.search(r"info curve \(target MSE per #revealed\): (.*)",
                      out).group(1).split()
    assert len(curve) == D and all(np.isfinite(float(v)) for v in curve)
    assert re.search(r"\[timing\] episode \d+\.\ds", out)

    # the JAX entry point's config of this record: p_missingness 30,
    # alpha 1.0, and its artifact paths
    jc = jcfg.RunConfig.from_jsonl_record(record, alpha=1.0,
                                          p_missingness=30)
    paths = jart.active_learning_paths(jc, "experiments")
    M = jc.M
    shapes = {"information_curve": (1, N, D), "action": (1, N, D - 1),
              "R_hist": (1, D - 1, N, D - 1), "im": (1, D - 1, M, N, D)}
    for name, shape in shapes.items():
        saved = torch.load(paths[name], weights_only=True)
        assert saved.dtype == torch.float32 and saved.shape == shape, name
    saved_curve = torch.load(paths["information_curve"], weights_only=True)
    np.testing.assert_allclose(saved_curve[0, 0].numpy(),
                               np.array(curve, np.float64), atol=5e-5)
    actions = torch.load(paths["action"], weights_only=True)[0]
    for row in actions.numpy().astype(int):
        assert sorted(row.tolist()) == list(range(D - 1))
    with open(os.path.join("experiments", jc.experiment_type, jc.data_type,
                           "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    final = [r for r in recs if r["metric"] == "al_final_mse"]
    assert len(final) == 1 and final[0]["stage"] == "test"
    assert final[0]["value"] == pytest.approx(
        float(saved_curve[0, 0, -1]), rel=1e-6)
    # the checkpoint the episode read is the one the grid trained
    assert os.path.isfile(jckpt.checkpoint_path(jc, "experiments"))


@pytest.mark.parametrize("flags,slice_name", [
    # a spec that is not integers: int()'s ValueError, as in JAX
    (["-mesh", "dp=2"], (ValueError, "invalid literal for int")),
    # a mesh (one device, '1,1') beside -seeds: runs since slice 10 part 2
    (["-mesh", "1,1", "-seeds", "2"], None),
    # ported since (slice 9 part 2): they run
    (["-ensemble", "true"], None),
    (["-seeds", "2"], None),
])
def test_unported_flags_are_refused(tmp_path, monkeypatch, capsys, flags,
                                    slice_name):
    """A -mesh that is not integers raises int()'s ValueError. The
    ensemble flags run: over a record trained with -seeds 2, `-ensemble
    true` makes one ensemble episode and writes the seed-0 artifacts, and
    `-seeds 2` a two-seed episode writing the `.seed1` siblings too, on a
    one-device mesh with `-mesh 1,1` (its line tagged)."""
    if slice_name is not None:
        monkeypatch.chdir(_workdir(tmp_path, [_record(VANILLA_VAE)]))
        with pytest.raises(slice_name[0], match=slice_name[1]):
            active_learning.main(flags + ["-device", "cpu"])
        return
    record = _record(VANILLA_VAE, epoch=1, M=2)
    monkeypatch.chdir(_workdir(tmp_path, [record]))
    assert imputation.main(["-device", "cpu", "-seeds", "2"]) == 0
    capsys.readouterr()
    assert active_learning.main(flags + ["-device", "cpu"]) == 0
    out = capsys.readouterr().out
    seeds = 2 if "-seeds" in flags else 1
    tag = " mesh={'dp': 1, 'tp': 1}" if "-mesh" in flags else ""
    assert ("=== active learning vanilla_vae1 (ensemble" in out
            if seeds == 1 else
            f"=== active learning vanilla_vae1 (seeds=2){tag} ===" in out)
    jc = jcfg.RunConfig.from_jsonl_record(record, alpha=1.0,
                                          p_missingness=30)
    for name, path in jart.active_learning_paths(jc, "experiments").items():
        assert os.path.isfile(path), name
        assert os.path.isfile(path + ".seed1") == (seeds == 2), name


def test_a_missing_checkpoint_stops_the_run_with_its_path(tmp_path,
                                                          monkeypatch):
    record = _record(VANILLA_VAE, M=2)
    monkeypatch.chdir(_workdir(tmp_path, [record]))
    jc = jcfg.RunConfig.from_jsonl_record(record, alpha=1.0,
                                          p_missingness=30)
    path = jckpt.checkpoint_path(jc, "experiments")
    with pytest.raises(FileNotFoundError, match=re.escape(path)):
        active_learning.main(["-device", "cpu"])


def test_restart_and_early_stop_flags_are_accepted_and_ignored(
        tmp_path, monkeypatch, capsys):
    """-checkpoint_every, -resume and -early_stop parse and change nothing
    in an episode, as in the JAX entry point (nothing trains here): the
    same information curve with and without them."""
    _trained(tmp_path, monkeypatch, VANILLA_VAE)
    curves = []
    for flags in ([], ["-checkpoint_every", "5", "-resume", "true",
                       "-early_stop", "true"]):
        capsys.readouterr()
        assert active_learning.main(["-device", "cpu", *flags]) == 0
        curves.append(re.search(r"info curve \(target MSE per #revealed\): "
                                r"(.*)", capsys.readouterr().out).group(1))
    assert curves[0] == curves[1]
    assert not any(f.endswith(".resume.pt") for _, _, files in
                   os.walk("experiments") for f in files)


def test_a_bfloat16_record_runs_its_episode_and_writes_jax_s_files(
        tmp_path, monkeypatch, capsys):
    """Record 37 (reg_EDDI1) asking for compute_dtype 'bfloat16', refused
    by both entry points until the mixed-precision slice: it trains
    through `imputation`, then its episode runs and writes JAX's four
    artifacts at their names and shapes."""
    record = _record(REG_EDDI, epoch=2, M=2, compute_dtype="bfloat16")
    monkeypatch.chdir(_workdir(tmp_path, [record]))
    assert imputation.main(["-device", "cpu"]) == 0
    capsys.readouterr()
    assert active_learning.main(["-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "=== active learning reg_EDDI1 ===" in out and "not run" not in out
    jc = jcfg.RunConfig.from_jsonl_record(record, alpha=1.0,
                                          p_missingness=30)
    assert jc.compute_dtype == "bfloat16"
    shapes = {"information_curve": (1, N, D), "action": (1, N, D - 1),
              "R_hist": (1, D - 1, N, D - 1), "im": (1, D - 1, 2, N, D)}
    for name, path in jart.active_learning_paths(jc, "experiments").items():
        saved = torch.load(path, weights_only=True)
        assert saved.dtype == torch.float32, name
        assert saved.shape == shapes[name], name
        assert torch.isfinite(saved).all(), name

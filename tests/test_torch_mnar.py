"""The port's MNAR pipeline against the JAX package's: the four MNAR mask
generators (bits equal), `data_loader_mnar` on the wine splits (arrays
equal), `eval_vae_mnar` under JAX's replayed rep keys (the RMSE within
1e-5), `eval_mnar_paths` (names equal), the saved tensor and metrics.jsonl
record, and the `imputation_mnar` entry point on the CPU."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.data import loaders as jloaders
from vae_posterior_consistency_tpu.engine import artifacts as jart
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu.engine import evaluate as jeval
from vae_posterior_consistency_tpu.models import get_model as jget_model
from vae_posterior_consistency_tpu.ops import masks as jmasks
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.data import loaders as tloaders
from vae_posterior_consistency_tpu_torch.engine import artifacts as tart
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.engine import evaluate as teval
from vae_posterior_consistency_tpu_torch.experiment_main import (
    imputation_mnar,
)
from vae_posterior_consistency_tpu_torch.ops import masks as tmasks
from test_torch_evaluate import JaxEvalKeys, _t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the port's full-matrix RMSE against JAX's under the same keys: float32
#: sums over the 178 x 12 cells in another order, and K-sample softmax
#: weights whose logsumexps round an ulp or two apart
RMSE_ATOL = 1e-5


class JaxMnarKeys:
    """Replays the JAX MNAR evaluator's key stream as a port noise source
    (engine/evaluate.py:320-372): rep m's key is fold_in(PRNGKey(seed + 2),
    m), split into (k_maskp, k_model); the rep's mask_p uniforms come from
    k_maskp (ops/masks.sub_mask), its eps from k_model as the family's
    eval_step draws it (JaxEvalKeys.eps). One batch a rep: step 0."""

    def __init__(self, key, cfg):
        self.key = key
        self.eps = JaxEvalKeys(None, cfg).eps

    def __call__(self, kind, rep, step, shape):
        assert step == 0, step
        k_maskp, k_model = jax.random.split(jax.random.fold_in(self.key, rep))
        if kind == "mask_p":
            return _t(jax.random.uniform(k_maskp, shape))
        assert kind == "eps", kind
        return self.eps(k_model, shape)


# ---------------------------------------------------------------------------
# mask generators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jmasks.MNAR_GENERATORS))
@pytest.mark.parametrize("shape", [(40, 7), (178, 12)], ids=["odd", "wine"])
def test_mnar_generators_give_jax_bits(name, shape):
    assert sorted(tmasks.MNAR_GENERATORS) == sorted(jmasks.MNAR_GENERATORS)
    rng = np.random.default_rng(len(name) + shape[1])
    x = rng.gamma(2.0, 1.0, shape).astype(np.float32)
    want = np.asarray(jmasks.MNAR_GENERATORS[name](jnp.asarray(x)))
    got = tmasks.MNAR_GENERATORS[name](torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    hidden = want == 0.0
    assert hidden.any() and not hidden.all()
    if "half" in name:
        assert not hidden[:, shape[1] // 2:].any()


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transform", ["minmax", "stand"])
@pytest.mark.parametrize("split", [1, 2, 3])
def test_data_loader_mnar_matches_jax(split, transform):
    vae_type = f"reg_notMIWAE{split}"
    want = jloaders.data_loader_mnar("Data", vae_type, 50, 64, "wine",
                                     data_transform=transform)
    got = tloaders.data_loader_mnar("Data", vae_type, 50, 64, "wine",
                                    data_transform=transform, device="cpu")
    assert got.test is None and want.test is None
    assert got.obs_dim == want.obs_dim == 12
    assert got.train.stage == "train"
    np.testing.assert_array_equal(got.train.x.numpy(),
                                  np.asarray(want.train.x))
    np.testing.assert_array_equal(got.train.mask.numpy(),
                                  np.asarray(want.train.mask))
    assert got.train.x.dtype == got.train.mask.dtype == torch.float32


def test_the_mnar_mask_is_not_permuted_twice():
    """The mask file was built from the permuted table: its holes are the
    cells above their column's mean there (data/generate.py), so they line
    up with the loaded rows only when the mask is taken as it is."""
    ds = tloaders.data_loader_mnar("Data", "reg_notMIWAE1", 50, 64, "wine",
                                   device="cpu")
    x, mask = ds.train.x, ds.train.mask
    above = x > x.mean(dim=0)
    hidden = mask == 0.0
    assert (hidden & ~above).sum() < (hidden & above).sum() / 10


# ---------------------------------------------------------------------------
# evaluator
# ---------------------------------------------------------------------------


def _mnar_params(jc, obs_dim, seed=7):
    jparams = jget_model(jc).init(jax.random.PRNGKey(seed), jc, obs_dim)
    return jparams, tckpt.params_from_jax(jckpt._flatten(jparams), "cpu")


def _cfgs(vae_type, **kw):
    kw = dict(vae_type=vae_type, M=2, valid_k=20, missing_rate=50,
              p_missingness=50, seed=3, **kw)
    return jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)


def _wine():
    """The MNAR wine table and its mask, as JAX arrays and as tensors."""
    j = jloaders.data_loader_mnar("Data", "reg_notMIWAE1", 50, 64, "wine")
    x, mask = j.train.x, j.train.mask
    return x, mask, _t(x), _t(mask)


@pytest.mark.parametrize("vae_type", ["vanilla_notMIWAE1", "reg_notMIWAE1",
                                      "reg_MIWAE1", "vanilla_vae1"])
def test_eval_vae_mnar_matches_jax_under_its_keys(vae_type):
    """M=2 reps over all 178 wine rows at valid_k 20; reg_MIWAE1 reads its
    fresh mask_p, the others draw none (the JAX package draws and
    discards one)."""
    jc, tc = _cfgs(vae_type)
    jparams, tparams = _mnar_params(jc, 12)
    x, mask, tx, tmask = _wine()
    want = jeval.eval_vae_mnar(x, mask, jc, params=jparams, save=False)
    got = teval.eval_vae_mnar(
        tx, tmask, tc, params=tparams, save=False,
        noise=JaxMnarKeys(jax.random.PRNGKey(tc.seed + 2), tc), device="cpu")
    assert isinstance(got, float) and np.isfinite(got)
    assert abs(got - want) <= RMSE_ATOL, (got, want)


def test_eval_vae_mnar_draws_only_what_the_family_reads():
    """One "eps" a rep for notMIWAE ([N, valid_k, L]); "mask_p" and then
    "eps" ([2, N, valid_k, L]) for reg_MIWAE1; each at step 0."""
    _, _, x, mask = _wine()
    for vae_type, want in (
            ("reg_notMIWAE1", [("eps", (178, 20, 10))]),
            ("reg_MIWAE1", [("mask_p", (178, 12)),
                            ("eps", (2, 178, 20, 10))])):
        _, tc = _cfgs(vae_type)
        seen = []
        src = JaxMnarKeys(jax.random.PRNGKey(0), tc)

        def noise(kind, rep, step, shape, _src=src, _seen=seen):
            _seen.append((kind, rep, step, tuple(shape)))
            return _src(kind, rep, step, shape)

        _, tparams = _mnar_params(_cfgs(vae_type)[0], 12)
        teval.eval_vae_mnar(x, mask, tc, params=tparams, save=False,
                            noise=noise, device="cpu")
        assert seen == [(k, m, 0, s) for m in range(2) for k, s in want]


def test_eval_vae_mnar_default_noise_is_seeded_and_params_load(tmp_path):
    """The default source is seeded with cfg.seed + 2; params=None reads
    the checkpoint at its reference path; a missing card raises."""
    jc, tc = _cfgs("reg_notMIWAE1")
    _, tparams = _mnar_params(jc, 12)
    _, _, x, mask = _wine()
    tckpt.save(tparams, tckpt.checkpoint_path(tc, str(tmp_path)))
    a = teval.eval_vae_mnar(x, mask, tc, params=tparams, save=False,
                            device="cpu")
    b = teval.eval_vae_mnar(x, mask, tc, experiments_root=str(tmp_path),
                            save=False, device="cpu")
    assert a == b
    c = teval.eval_vae_mnar(x, mask, tc.replace(seed=4), params=tparams,
                            save=False, device="cpu")
    assert c != a
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            teval.eval_vae_mnar(x, mask, tc, params=tparams, save=False)


def test_eval_vae_mnar_saves_what_jax_saves(tmp_path):
    """The rmse artifact at JAX's name, a 0-d float64 tensor, and one
    rmse_mnar record at stage 'test' with JAX's fields."""
    jc, tc = _cfgs("vanilla_notMIWAE1")
    jparams, tparams = _mnar_params(jc, 12)
    x, mask, tx, tmask = _wine()
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "torch")
    want = jeval.eval_vae_mnar(x, mask, jc, params=jparams,
                               experiments_root=jroot)
    got = teval.eval_vae_mnar(
        tx, tmask, tc, params=tparams, experiments_root=troot, device="cpu",
        noise=JaxMnarKeys(jax.random.PRNGKey(tc.seed + 2), tc))
    jpath = jart.eval_mnar_paths(jc, jroot)["rmse"]
    tpath = tart.eval_mnar_paths(tc, troot)["rmse"]
    assert os.path.relpath(tpath, troot) == os.path.relpath(jpath, jroot)
    jt = torch.load(jpath, weights_only=False)
    tt = torch.load(tpath, weights_only=False)
    assert (tt.dtype, tt.shape) == (jt.dtype, jt.shape) == (torch.float64,
                                                           torch.Size([]))
    assert tt.item() == got and abs(tt.item() - jt.item()) <= RMSE_ATOL
    assert jt.item() == want

    def records(root):
        path = os.path.join(root, jc.experiment_type, jc.data_type,
                            "metrics.jsonl")
        return [json.loads(line) for line in open(path)]

    (jrec,), (trec,) = records(jroot), records(troot)
    assert list(trec) == list(jrec)
    for key in jrec:
        if key == "value":
            assert abs(trec[key] - jrec[key]) <= RMSE_ATOL
        elif key != "time":
            assert trec[key] == jrec[key], key
    assert (trec["metric"], trec["stage"]) == ("rmse_mnar", "test")


@pytest.mark.parametrize("vae_type", ["vanilla_notMIWAE1", "reg_notMIWAE2"])
@pytest.mark.parametrize("not_miwae_type", ["changed", "author"])
def test_eval_mnar_paths_are_jax_paths(vae_type, not_miwae_type):
    kw = dict(vae_type=vae_type, not_miwae_type=not_miwae_type, alpha=0.5,
              p_missingness=50, missing_rate=30)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    assert (tart.eval_mnar_paths(tc, "root")
            == jart.eval_mnar_paths(jc, "root"))
    folder = os.path.basename(os.path.dirname(
        tart.eval_mnar_paths(tc)["rmse"]))
    assert folder == vae_type.rstrip("12")


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def _workdir(tmp_path):
    """A directory holding Data/imputation_args_mnar.json, the grid's two
    records as they stand, and a copy of Data/wine."""
    os.makedirs(tmp_path / "Data")
    shutil.copytree(os.path.join(REPO, "Data", "wine"),
                    tmp_path / "Data" / "wine")
    shutil.copy(os.path.join(REPO, "Data", "imputation_args_mnar.json"),
                tmp_path / "Data" / "imputation_args_mnar.json")
    return tmp_path


def test_entry_point_runs_both_records_and_writes_jax_names(
        tmp_path, monkeypatch, capsys):
    """Both records of the MNAR grid (vanilla_notMIWAE1, reg_notMIWAE1),
    1 epoch, valid_k cut to 20 on the CPU: each checkpoint and rmse
    artifact lands where the JAX entry point puts it, and the rmse printed
    is the one saved."""
    monkeypatch.chdir(_workdir(tmp_path))
    assert imputation_mnar.main(["-device", "cpu", "-valid_k", "20"]) == 0
    out = capsys.readouterr().out
    rmses = [float(line.split("=")[1]) for line in out.splitlines()
             if line.startswith("  rmse=")]
    assert len(rmses) == 2 and all(np.isfinite(rmses))
    assert out.count("  [timing] train ") == 2
    records = [json.loads(line) for line in
               open(os.path.join("Data", "imputation_args_mnar.json"))]
    for record, rmse in zip(records, rmses):
        vae_type = record["vae_type"]["default"]
        assert f"=== train {vae_type} (MNAR, missing=50, alpha=1.0) ===" in out
        jc = jcfg.RunConfig.from_jsonl_record(
            record, valid_k=20, alpha=1.0, p_missingness=50,
            data_transform="minmax", not_miwae_type="changed")
        assert os.path.isfile(jckpt.checkpoint_path(jc, "experiments"))
        saved = torch.load(jart.eval_mnar_paths(jc, "experiments")["rmse"],
                           weights_only=False)
        assert saved.dtype == torch.float64
        assert f"{saved.item():.5f}" == f"{rmse:.5f}"


@pytest.mark.parametrize("flags,slice_", [
    # the ensemble flags pass now (slice 9), and beside a mesh ('1,1'
    # resolves to one, where 'auto' on one device does not) since slice
    # 10 part 2: the seed ensemble trains on it under a trace
    (["-seeds", "2", "-mesh", "1,1", "-profile", "t2"], None),
    # -profile passes now too (slice 11): the run goes on under a trace
    (["-ensemble", "true", "-profile", "t"], None),
    # a spec that is not integers: int()'s ValueError, as in JAX
    (["-mesh", "dp:2"], (ValueError, "invalid literal for int")),
    (["-profile", "traces"], None)])
def test_entry_point_refuses_unported_flags_by_slice(tmp_path, monkeypatch,
                                                     capsys, flags, slice_):
    monkeypatch.chdir(_workdir(tmp_path))
    if slice_ is not None:
        with pytest.raises(slice_[0], match=slice_[1]):
            imputation_mnar.main(["-device", "cpu", *flags])
        assert not os.path.exists(tmp_path / "experiments")
        return
    assert imputation_mnar.main(["-device", "cpu", "-valid_k", "20",
                                 *flags]) == 0
    logdir = flags[flags.index("-profile") + 1]
    assert f"[profile] tracing to {logdir}" in capsys.readouterr().out
    assert any(os.path.getsize(os.path.join(logdir, f)) > 0
               for f in os.listdir(logdir))
    assert os.path.isdir(tmp_path / "experiments")


@pytest.mark.parametrize("flags", [
    ["-checkpoint_every", "1", "-resume", "true"],
    ["-early_stop", "true", "-patience", "1"]])
def test_entry_point_passes_restart_and_early_stop_flags_to_train(
        tmp_path, monkeypatch, flags):
    """-checkpoint_every/-resume and -early_stop reach `train` on the
    serial path, as the JAX entry point passes them
    (experiment_main/imputation_mnar.py:112-141): each record gets a fresh
    EarlyStopping at its patience, or writes its resume file at its last
    epoch, from which a second run resumes with nothing left to train."""
    from vae_posterior_consistency_tpu_torch.engine import train as ttrain
    from vae_posterior_consistency_tpu_torch.utils.early_stopping import (
        EarlyStopping,
    )

    monkeypatch.chdir(_workdir(tmp_path))
    real, seen = ttrain.train, []

    def spy(dataset, cfg, **kw):
        params, history = real(dataset, cfg, **kw)
        seen.append((cfg, kw, history))
        return params, history

    monkeypatch.setattr(ttrain, "train", spy)
    argv = ["-device", "cpu", "-valid_k", "20", *flags]
    runs = 2 if "-resume" in flags else 1
    for _ in range(runs):
        assert imputation_mnar.main(argv) == 0
    assert len(seen) == 2 * runs
    if "-early_stop" in flags:
        trackers = [kw["early_stopping"] for _, kw, _ in seen]
        assert all(isinstance(es, EarlyStopping) and es.patience == 1
                   and es.best_params is not None for es in trackers)
        assert trackers[0] is not trackers[1]
        assert all((kw["checkpoint_every"], kw["resume"]) == (None, False)
                   for _, kw, _ in seen)
        return
    for cfg, kw, history in seen:
        assert (kw["checkpoint_every"], kw["resume"],
                kw["early_stopping"]) == (1, True, None)
    for cfg, _, history in seen[:2]:
        assert len(history) == cfg.epoch
        path = tckpt.checkpoint_path(cfg, "experiments")
        saved = torch.load(path + ".resume.pt", weights_only=False)
        assert int(saved["epoch"]) == cfg.epoch
        final = torch.load(path, weights_only=False)
        for k, v in final.items():
            np.testing.assert_array_equal(saved["params/" + k], v)
    assert [h for _, _, h in seen[2:]] == [[], []]


def test_entry_point_without_its_grid_raises(tmp_path, monkeypatch):
    """Without its grid the entry point no longer raises for it: it writes
    the JAX package's default grids into Data/ first, as JAX's does, and
    stops at the first file it then misses, the first record's data."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="data.pt") as err:
        imputation_mnar.main(["-device", "cpu"])
    assert "imputation_args" not in str(err.value)
    with open(os.path.join("Data", "imputation_args_mnar.json")) as fh:
        assert [json.loads(line) for line in fh] == [
            json.loads(line) for line in open(os.path.join(
                REPO, "Data", "imputation_args_mnar.json"))]


def test_a_bfloat16_grid_runs_and_writes_jax_names(tmp_path, monkeypatch,
                                                   capsys):
    """Both MNAR records asking for compute_dtype 'bfloat16' (1 epoch,
    valid_k 20): each trains, saves its checkpoint and its rmse artifact
    where the JAX entry point puts them, the rmse printed the one saved."""
    work = _workdir(tmp_path)
    grid = work / "Data" / "imputation_args_mnar.json"
    records = [json.loads(line) for line in open(grid)]
    with open(grid, "w") as fh:
        for record in records:
            record["compute_dtype"] = {"type": "str", "help": "",
                                       "default": "bfloat16"}
            fh.write(json.dumps(record) + "\n")
    monkeypatch.chdir(work)
    assert imputation_mnar.main(["-device", "cpu", "-valid_k", "20",
                                 "-epoch", "1"]) == 0
    out = capsys.readouterr().out
    rmses = [float(line.split("=")[1]) for line in out.splitlines()
             if line.startswith("  rmse=")]
    assert len(rmses) == 2 and all(np.isfinite(rmses))
    for record, rmse in zip(records, rmses):
        jc = jcfg.RunConfig.from_jsonl_record(
            record, valid_k=20, epoch=1, alpha=1.0, p_missingness=50,
            data_transform="minmax", not_miwae_type="changed")
        assert jc.compute_dtype == "bfloat16"
        assert os.path.isfile(jckpt.checkpoint_path(jc, "experiments"))
        saved = torch.load(jart.eval_mnar_paths(jc, "experiments")["rmse"],
                           weights_only=False)
        assert f"{saved.item():.5f}" == f"{rmse:.5f}"

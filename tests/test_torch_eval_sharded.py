"""The port's mesh evaluation and the entry points' `-mesh` paths:
`engine/evaluate_sharded` against the JAX package's on a dp = 2 mesh of its
virtual CPU devices under replayed keys; `imputation` and `imputation_mnar`
with `-mesh 2,1` on two gloo ranks (`torch_dist_worker.spawn`, one spawn
for the module); `-mesh auto` on one process, which resolves to the
single-device engine in all four entry points; a resolved mesh on the
paths of slice 10 part 2 run on a one-device mesh."""

import json
import math
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.engine import artifacts as jart
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu.engine import evaluate_sharded as jes
from vae_posterior_consistency_tpu.models import get_model as jget_model
from vae_posterior_consistency_tpu.parallel import mesh as jmesh
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.experiment_main import (
    active_learning,
    ais_eval,
    imputation,
    imputation_mnar,
)
from vae_posterior_consistency_tpu_torch.models import get_model

import torch_dist_worker as worker
from test_torch_evaluate import JaxEvalKeys
from test_torch_imputation_entry import REPO, _record, _workdir
from test_torch_parallel import _jds, record

#: whole-split aggregates under the same draws: the same float32 sums in
#: another order
RMSE_ATOL, RTOL = 1e-5, 1e-5
#: the eval cases: 21 train and 9 test rows (one padded row each on dp =
#: 2), 6 features, 2 reps
N_TRAIN, N_TEST, D, M = 21, 9, 6, 2
EVAL_CASES = {
    "reg_vae1": dict(vae_type="reg_vae1"),
    "reg_MIWAE1": dict(vae_type="reg_MIWAE1", valid_k=7),
    "reg_flow1": dict(vae_type="reg_flow1", hid_dim=16),
}
MNAR_RECORD = 2  # reg_notMIWAE1, the second record of the MNAR grid


class JaxShardedEvalKeys:
    """The keys of JAX's `eval_split_sharded` (evaluate_sharded.py:46-66):
    rep m's key fold_in(key, m), split into (k_maskp, k_model); the mask_p
    uniforms from k_maskp at the padded split's shape, the family's eps
    from k_model as its `eval_step` draws them (`JaxEvalKeys.eps`)."""

    def __init__(self, key, cfg):
        self.key, self.eval_keys = key, JaxEvalKeys(key, cfg)

    def __call__(self, kind, rep, step, shape):
        assert step == 0
        k_maskp, k_model = jax.random.split(jax.random.fold_in(self.key, rep))
        if kind == "mask_p":
            return torch.from_numpy(np.array(
                jax.random.uniform(k_maskp, shape)))
        return self.eval_keys.eps(k_model, shape)


def _eval_data(seed=4):
    rng = np.random.default_rng(seed)

    def draw(rows):
        return (rng.uniform(0.0, 1.0, (rows, D)).astype(np.float32),
                (rng.random((rows, D)) < 0.7).astype(np.float32))

    return draw(N_TRAIN) + draw(N_TEST)


def _eval_case(name, root):
    """JAX's `eval_vae_sharded` on a dp = 2 mesh, artifacts into
    root/jax, and the port job replaying its keys into root/port."""
    kw = dict(EVAL_CASES[name], M=M, seed=2)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    data = _eval_data()
    params = jget_model(jc).init(jax.random.PRNGKey(6), jc, D)
    mesh = jmesh.make_mesh(jax.devices()[:2], dp=2, tp=1)
    want = jes.eval_vae_sharded(_jds(data), jc, mesh, params=params,
                                experiments_root=str(root / "jax"))
    keys = JaxShardedEvalKeys(jax.random.PRNGKey(jc.seed + 1), tc)
    model = get_model(tc)
    reqs = []
    for n in (N_TRAIN, N_TEST):
        pad = math.ceil(n / 2) * 2
        for m in range(M):
            reqs.append(("mask_p", m, 0, (pad, D)))
            reqs += [(k, m, 0, shape) for k, shape
                     in model.eval_noise(tc, pad, D).items() if k != "mask_p"]
    flat = {k: np.asarray(v) for k, v in jckpt._flatten(params).items()}
    job = ("eval", dict(cfg=kw, data=data, params=flat,
                        draws=record(keys, reqs), root=str(root / "port")))
    return job, want


def _mnar_workdir(path):
    """Data/ with the MNAR grid cut to `MNAR_RECORD` and a copy of wine."""
    os.makedirs(path / "Data")
    shutil.copytree(os.path.join(REPO, "Data", "wine"),
                    path / "Data" / "wine")
    with open(os.path.join(REPO, "Data", "imputation_args_mnar.json")) as fh:
        line = [ln for ln in fh if ln.strip()][MNAR_RECORD - 1]
    (path / "Data" / "imputation_args_mnar.json").write_text(line)
    return path


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of 2 ranks: the three eval cases, then the two entry
    points at -mesh 2,1 (1 epoch, M 1) in their own directories."""
    tmp = tmp_path_factory.mktemp("eval_sharded")
    cases = {name: _eval_case(name, tmp / name) for name in EVAL_CASES}
    mcar = _workdir(tmp / "mcar", [_record(34, epoch=1, M=1)])
    mnar = _mnar_workdir(tmp / "mnar")
    entries = {
        "imputation": ("entry", dict(
            module="imputation", workdir=str(mcar),
            argv=["-device", "cpu", "-mesh", "2,1"])),
        "imputation_mnar": ("entry", dict(
            module="imputation_mnar", workdir=str(mnar),
            argv=["-device", "cpu", "-mesh", "2,1", "-epoch", "1",
                  "-valid_k", "20", "-M", "1"])),
    }
    names = list(cases) + list(entries)
    ranks = worker.spawn([job for job, _ in cases.values()]
                         + list(entries.values()), 2, tmp / "pg")
    got = [dict(zip(names, r)) for r in ranks]
    return got, {k: w for k, (_, w) in cases.items()}, tmp


def _tree(root):
    """{relative path: file} under root, metrics.jsonl aside."""
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("name", list(EVAL_CASES))
def test_eval_vae_sharded_matches_jax_s_under_its_keys(two_ranks, name):
    """Both splits, one padded row each, 2 reps: rmse atol 1e-5, loss,
    negl and negl_imp rtol 1e-5, the same on both ranks."""
    got, want, _ = two_ranks
    for rank in got:
        res = rank[name]["results"]
        assert list(res) == list(want[name])
        for stage, metrics in want[name].items():
            assert list(res[stage]) == list(metrics)
            for k, v in metrics.items():
                if k == "rmse":
                    assert abs(res[stage][k] - v) <= RMSE_ATOL, (stage, k)
                else:
                    np.testing.assert_allclose(res[stage][k], v, rtol=RTOL,
                                               err_msg=f"{stage} {k}")


@pytest.mark.parametrize("name", list(EVAL_CASES))
def test_eval_vae_sharded_writes_jax_s_artifacts_once(two_ranks, name):
    """Rank 0 alone writes, at JAX's names, what JAX writes (the MIWAE
    family the rmse only), each value within the metrics' bounds."""
    got, _, tmp = two_ranks
    assert got[1][name]["writes"] == 0
    port, jax_root = tmp / name / "port", tmp / name / "jax"
    files = _tree(jax_root)
    assert _tree(port) == files
    assert got[0][name]["writes"] == len(files) - 1  # metrics.jsonl aside
    for rel in files:
        if rel.endswith(".jsonl"):
            lines = [open(os.path.join(r, rel)).read().splitlines()
                     for r in (port, jax_root)]
            assert len(lines[0]) == len(lines[1])
            continue
        a = torch.load(os.path.join(port, rel), weights_only=False)
        b = torch.load(os.path.join(jax_root, rel), weights_only=False)
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=RMSE_ATOL)


def test_imputation_mesh_2_1_on_two_ranks_prints_once_and_writes_jax_files(
        two_ranks):
    """`imputation -mesh 2,1` on two ranks: JAX's train line with its mesh
    tag, the eval lines, printed by rank 0 alone; the checkpoint and the
    four artifacts a split at JAX's names."""
    got, _, tmp = two_ranks
    r0, r1 = got[0]["imputation"], got[1]["imputation"]
    assert r0["rc"] == r1["rc"] == 0
    assert r1["out"] == ""
    out = r0["out"]
    assert out.count("=== train reg_vae1 (missing=30, alpha=1.0) "
                     "mesh={'dp': 2, 'tp': 1} ===") == 1
    assert out.count("  [test] ") == 1 and out.count("  [train] ") == 1
    cfg = jcfg.RunConfig.from_jsonl_record(_record(34), alpha=1.0,
                                           p_missingness=30)
    root = str(tmp / "mcar" / "experiments")
    assert os.path.isfile(jckpt.checkpoint_path(cfg, root))
    for stage in ("train", "test"):
        for path in jart.eval_vae_paths(cfg, stage, root).values():
            assert np.isfinite(torch.load(path, weights_only=False).item())


def test_imputation_mnar_mesh_2_1_on_two_ranks(two_ranks):
    """`imputation_mnar -mesh 2,1`: trained on the mesh, evaluated on the
    gathered parameters; rank 0 prints the tagged train line and the rmse
    once and writes the checkpoint and the rmse artifact."""
    got, _, tmp = two_ranks
    r0, r1 = got[0]["imputation_mnar"], got[1]["imputation_mnar"]
    assert r0["rc"] == r1["rc"] == 0 and r1["out"] == ""
    out = r0["out"]
    assert out.count("=== train reg_notMIWAE1 (MNAR, missing=50, "
                     "alpha=1.0) mesh={'dp': 2, 'tp': 1} ===") == 1
    rmse = [ln for ln in out.splitlines() if ln.startswith("  rmse=")]
    assert len(rmse) == 1
    with open(tmp / "mnar" / "Data" / "imputation_args_mnar.json") as fh:
        rec = json.loads(fh.read())
    cfg = jcfg.RunConfig.from_jsonl_record(
        rec, alpha=1.0, p_missingness=50, data_transform="minmax",
        not_miwae_type="changed")
    root = str(tmp / "mnar" / "experiments")
    assert os.path.isfile(jckpt.checkpoint_path(cfg, root))
    saved = torch.load(jart.eval_mnar_paths(cfg, root)["rmse"],
                       weights_only=False).item()
    assert f"{saved:.5f}" == rmse[0].split("=")[1]


# ---------------------------------------------------------------------------
# one process: -mesh auto, -mesh 1,1, the part-2 refusals
# ---------------------------------------------------------------------------

def _seeded_checkpoint(root, record):
    cfg = tcfg.RunConfig.from_jsonl_record(record, alpha=1.0,
                                           p_missingness=30)
    params = get_model(cfg).init(torch.Generator().manual_seed(1), cfg, 13,
                                 device="cpu")
    tckpt.save(params, tckpt.checkpoint_path(cfg, str(root / "experiments")))


def _run_entry(name, path, flags):
    """Run entry point `name` in a fresh directory at `path` with `flags`
    (on the CPU, cut small); returns what it printed."""
    import contextlib
    import io

    record = _record(34, epoch=1, M=1, n_ais_dist=3, n_ais_iwae=2)
    if name == "imputation_mnar":
        _mnar_workdir(path)
    else:
        _workdir(path, [record])
    if name in ("active_learning", "ais_eval"):
        _seeded_checkpoint(path, record)
    argv = {"imputation": [], "imputation_mnar": ["-epoch", "1", "-valid_k",
                                                  "20", "-M", "1", "-train_k",
                                                  "2"],
            "active_learning": ["-M", "2"], "ais_eval": []}[name]
    main = {"imputation": imputation, "imputation_mnar": imputation_mnar,
            "active_learning": active_learning, "ais_eval": ais_eval}[name]
    cwd, buf = os.getcwd(), io.StringIO()
    os.chdir(path)
    try:
        with contextlib.redirect_stdout(buf):
            assert main.main(["-device", "cpu", *argv, *flags]) == 0
    finally:
        os.chdir(cwd)
    return buf.getvalue()


@pytest.mark.parametrize("name", ["imputation", "imputation_mnar",
                                  "active_learning", "ais_eval"])
def test_mesh_auto_on_one_device_runs_the_single_device_engine(tmp_path,
                                                               name):
    """ROADMAP C.8: `-mesh auto` with one device resolves to no mesh, as in
    JAX, so each entry point runs its single-device engine: no mesh tag,
    no process group, and the files a `-mesh ''` run writes, value for
    value."""
    plain = _run_entry(name, tmp_path / "plain", [])
    auto = _run_entry(name, tmp_path / "auto", ["-mesh", "auto"])
    assert "mesh=" not in auto
    assert not torch.distributed.is_initialized()
    a, b = tmp_path / "plain" / "experiments", tmp_path / "auto" / "experiments"
    files = _tree(a)
    assert files and _tree(b) == files
    for rel in files:
        if rel.endswith(".jsonl"):
            continue
        x = torch.load(os.path.join(a, rel), weights_only=False)
        y = torch.load(os.path.join(b, rel), weights_only=False)
        for k, v in (x.items() if isinstance(x, dict) else [(rel, x)]):
            w = y[k] if isinstance(y, dict) else y
            np.testing.assert_array_equal(np.asarray(v), np.asarray(w))
    def untimed(out):
        return [re.sub(r"\([\d.]+ epochs/s\)", "", ln)
                for ln in out.splitlines() if "[timing]" not in ln]

    assert untimed(auto) == untimed(plain)


@pytest.mark.parametrize("debug_nans", ["", "1"])
def test_mesh_1_1_in_one_process_runs_the_sharded_engine(tmp_path,
                                                         monkeypatch,
                                                         debug_nans):
    """A one-device mesh needs no torchrun: `-mesh 1,1` makes a
    world-size-1 group, tags the train line, trains with `train_sharded`
    and evaluates with `eval_vae_sharded`, and destroys the group at the
    end; under VPC_DEBUG_NANS too (the tripwire checks the DTensor
    parameters and gradients shard by shard)."""
    from vae_posterior_consistency_tpu_torch.utils import debugging

    monkeypatch.setenv("VPC_DEBUG_NANS", debug_nans)
    try:
        out = _run_entry("imputation", tmp_path, ["-mesh", "1,1"])
    finally:
        debugging.enable_nan_debugging(False)
    assert ("=== train reg_vae1 (missing=30, alpha=1.0) "
            "mesh={'dp': 1, 'tp': 1} ===") in out
    assert "  [test] " in out
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("module,flags", [
    (imputation, ["-seeds", "2"]), (imputation, ["-ensemble", "true"]),
    (imputation_mnar, ["-seeds", "2"]), (active_learning, []),
    (ais_eval, [])])
def test_a_resolved_mesh_on_a_part_2_path_is_refused(tmp_path, monkeypatch,
                                                     module, flags):
    """`-mesh 1,1` resolves to a mesh; beside the ensemble flags, and in
    the AL and AIS entry points, it runs since slice 10 part 2 (in one
    process, on a world-size-1 group the run makes and destroys) and
    writes the files the same flags write without a mesh, value for
    value."""
    name = {imputation: "imputation", imputation_mnar: "imputation_mnar",
            active_learning: "active_learning", ais_eval: "ais_eval"}[module]
    plain = _run_entry(name, tmp_path / "plain", flags)
    meshed = _run_entry(name, tmp_path / "mesh", ["-mesh", "1,1", *flags])
    assert "mesh={'dp': 1, 'tp': 1}" in meshed and "mesh=" not in plain
    assert not torch.distributed.is_initialized()
    a = tmp_path / "plain" / "experiments"
    b = tmp_path / "mesh" / "experiments"
    files = _tree(a)
    assert files and _tree(b) == files
    for rel in files:
        if rel.endswith(".jsonl"):
            continue
        x = torch.load(os.path.join(a, rel), weights_only=False)
        y = torch.load(os.path.join(b, rel), weights_only=False)
        for k, v in (x.items() if isinstance(x, dict) else [(rel, x)]):
            w = y[k] if isinstance(y, dict) else y
            np.testing.assert_array_equal(np.asarray(v), np.asarray(w))


def test_serving_over_a_mesh_waits_for_part_2():
    """The server's `mesh` (rows dp-sharded, engine/serve.py:32-48) runs
    since slice 10 part 2: on a one-device mesh it answers as the plain
    server, bit for bit."""
    from vae_posterior_consistency_tpu_torch.engine import serve
    from torch_dist_worker import one_rank_mesh

    cfg = tcfg.RunConfig(vae_type="reg_vae1")
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg, 13,
                                 device="cpu")
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(5, 13)).astype(np.float32)
    m = (rng.random((5, 13)) < 0.6).astype(np.float32)
    plain = serve.ImputationServer(params, cfg, 13, device="cpu")
    with one_rank_mesh() as mesh:
        meshed = serve.ImputationServer(params, cfg, 13, device="cpu",
                                        mesh=mesh)
        assert meshed.buckets == plain.buckets
        for a, b in zip(plain.impute(x, m), meshed.impute(x, m)):
            np.testing.assert_array_equal(a, b)

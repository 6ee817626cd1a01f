"""The port's ensembles over a mesh (`parallel/sweep`'s `mesh`) against the
JAX package's on a dp = 2 mesh of its virtual CPU devices, and the
ensemble paths of both imputation entry points under `-mesh 2,1`.

One spawn of 2 gloo ranks (`torch_dist_worker.spawn`) runs every job. The
parent runs JAX's trainers on the mesh and records the draws of JAX's
ensemble keys (`JaxEnsembleKeys`) at the padded replica count, with JAX's
stacked initial parameters of every padded row; the ranks replay them. Each
trainer has 3 replicas, so dp = 2 pads them to 4. Tolerances are the serial
ensembles' (`test_torch_sweep`): histories rtol 1e-4, parameters within
lr a step and at most one in a thousand over 1e-5. The entry points are
held to the JAX package's runs with the same flags: the same files, each
written once by rank 0, and the same banners with their mesh tag."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.parallel import sweep as jsweep
from vae_posterior_consistency_tpu.utils import early_stopping as jes
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.engine import train as ttrain
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.parallel import sweep as tsweep

import torch_dist_worker as worker
from cli_harness import REPO, grid_record
from test_torch_ensemble_entry import _run_jax, _written
from test_torch_parallel import _jmesh
from test_torch_resume import HIST_RTOL, JaxValKeys
from test_torch_sweep import (
    STEPS_PER_EPOCH,
    JaxEnsembleKeys,
    _cfgs,
    _close,
    _fold_keys,
    _jax_init,
    _seed_keys,
)

#: 20 rows of 6 at batch 8 (3 steps an epoch); the trainers run one epoch
#: (the mesh's padding and row cuts are the same every epoch), the resume
#: pair two and early stopping four
N, D, EPOCHS = 20, 6, 1


def _data(n=N, n_test=0, seed=1):
    rng = np.random.default_rng(seed)

    def draw(rows):
        return (rng.uniform(0.0, 1.0, (rows, D)).astype(np.float32),
                (rng.random((rows, D)) < 0.7).astype(np.float32))

    return draw(n) + (draw(n_test) if n_test else ())


def _jds(data):
    from test_torch_parallel import _jds as jds

    return jds(data)


def _epochs(keys, tc, n, epochs):
    """JAX's ensemble draws of `epochs` epochs on n rows, as numpy."""
    steps = -(-n // min(tc.batch_size, n))
    shapes = tsweep._noise_shapes(tc, get_model(tc), min(tc.batch_size, n),
                                  D)
    return [{k: v.numpy() for k, v in keys.epoch(e, n, steps, shapes).items()}
            for e in range(epochs)]


def _kw(tc):
    return {f: getattr(tc, f) for f in tc.__dataclass_fields__}


def _case(trainer, tc, data, keys, init, kwargs=None):
    """The port job of `trainer` from JAX's padded init under its keys."""
    return ("ensemble", dict(
        trainer=trainer, cfg=_kw(tc), data=data, params=init,
        epochs=_epochs(keys, tc, N, tc.epoch), kwargs=kwargs))


def _init(jc, keys):
    return {k: v.numpy() for k, v in
            tckpt.flatten(_jax_init(jc, D, keys)).items()}


def _trainer_cases():
    """{name: (port job, (JAX params, JAX history))} of the five trainers
    at 3 replicas on dp = 2, and early stopping."""
    jm = _jmesh(2, 1)
    cases = {}
    jc, tc = _cfgs("reg_vae1", epoch=EPOCHS, reg_type="kl_reg")
    data = _data()
    jds = _jds(data)
    seeds = [0, 1, 2]
    run_seeds = seeds + [2]
    want = jsweep.train_seed_ensemble(jds, jc, seeds, mesh=jm)
    cases["seed"] = (_case("train_seed_ensemble", tc, data,
                           JaxEnsembleKeys("seed", tc, 4, run_seeds),
                           _init(jc, _seed_keys(run_seeds)),
                           kwargs=dict(seeds=seeds)), want)

    splits = [_data(seed=1), _data(seed=2), _data(14, seed=3)]
    want = jsweep.train_split_ensemble([_jds(d) for d in splits], jc,
                                       mesh=jm)
    cases["split"] = (_case("train_split_ensemble", tc, splits,
                            JaxEnsembleKeys("split", tc, 4),
                            _init(jc, _fold_keys(jc.seed, 4))), want)

    jce, tce = _cfgs("reg_EDDI1", epoch=EPOCHS)
    alphas = [0.0, 0.5, 2.0]
    want = jsweep.train_alpha_ensemble(jds, jce, alphas, seed=5, mesh=jm)
    cases["alpha"] = (_case("train_alpha_ensemble", tce, data,
                            JaxEnsembleKeys("alpha", tce.replace(seed=5), 4),
                            _init(jce, _fold_keys(5, 4)),
                            kwargs=dict(alphas=alphas, seed=5)), want)

    row_seeds = [4, 4, 4, 4]
    want = jsweep.train_alpha_seed_ensemble(jds, jce, alphas, [4], mesh=jm)
    cases["alpha_seed"] = (_case(
        "train_alpha_seed_ensemble", tce, data,
        JaxEnsembleKeys("seed", tce, 4, row_seeds),
        _init(jce, _seed_keys(row_seeds)),
        kwargs=dict(alphas=alphas, seeds=[4])), want)

    missings = [20, 40, 60]
    want = jsweep.train_sweep_ensemble(jds, jc, missings=missings,
                                       mesh=jm)
    cases["sweep"] = (_case("train_sweep_ensemble", tc, data,
                            JaxEnsembleKeys("alpha", tc, 4),
                            _init(jc, _fold_keys(jc.seed, 4)),
                            kwargs=dict(missings=missings)), want)

    # per-replica early stopping: patience 1, delta 1e9, a check every 2
    # epochs on the test split, so it stops at epoch 4 of 20
    jc20, tc20 = _cfgs("reg_vae1", epoch=20)
    es_data = _data(n_test=7)
    tracker = jes.EnsembleEarlyStopping(patience=1, delta=1e9)
    want = jsweep.train_seed_ensemble(_jds(es_data), jc20, seeds, mesh=jm,
                                      chunk_epochs=2,
                                      early_stopping=tracker)
    vkeys = JaxValKeys(jax.random.PRNGKey(tc20.seed), tc20)
    shapes = tsweep._noise_shapes(tc20, get_model(tc20), 7, D)
    val = {(k, ttrain.VAL_EPOCH, 0, tuple(s)):
           vkeys(k, ttrain.VAL_EPOCH, 0, s).numpy() for k, s in shapes.items()}
    job = ("ensemble", dict(
        trainer="train_seed_ensemble", cfg=_kw(tc20), data=es_data,
        params=_init(jc20, _seed_keys(run_seeds)),
        epochs=_epochs(JaxEnsembleKeys("seed", tc20, 4, run_seeds), tc20, N,
                       4),
        kwargs=dict(seeds=seeds), val_draws=val, patience=1))
    cases["early_stop"] = (job, want + (tracker.best_loss,))
    return cases


#: one record of each family the entry points' ensembles train, at the
#: sizes of test_torch_ensemble_entry (synth_small, 1 epoch)
BASE = dict(data_type="synth_small", epoch=1, batch_size=16, M=1, train_k=2,
            valid_k=3, latent_dim=4, missing_rate=30, hid_dim=32)
MCAR = [grid_record(vae_type=f"reg_vae{i}", **BASE) for i in "123"]
MNAR = [grid_record(vae_type="reg_notMIWAE1", **BASE)]

ENTRY_PATHS = {
    "seeds": ("imputation", ["-seeds", "3"]),
    "split ensembles": ("imputation", ["-ensemble", "true"]),
    "MNAR seeds": ("imputation_mnar", ["-seeds", "3"]),
    "MNAR sweep": ("imputation_mnar", ["-ensemble", "true", "-missings",
                                       "20,40,50"]),
}
FLAGS = ["-mesh", "2,1", "-checkpoint_every", "1"]


def _workdir(path, path_name):
    """Data/ with synth_small and the grids of `path_name` (the serial
    -seeds grid one record, the split ensembles' the triple)."""
    os.makedirs(path / "Data")
    shutil.copytree(os.path.join(REPO, "Data", "synth_small"),
                    path / "Data" / "synth_small")
    mcar = MCAR[:1] if path_name == "seeds" else MCAR
    (path / "Data" / "imputation_args.json").write_text(
        "\n".join(mcar) + "\n")
    (path / "Data" / "imputation_args_mnar.json").write_text(
        "\n".join(MNAR) + "\n")
    return path


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of 2 ranks: the trainer cases, the resume pair, then the
    four entry paths, each in its own directory."""
    tmp = tmp_path_factory.mktemp("mesh_sweep")
    cases = _trainer_cases()
    jc, tc = _cfgs("reg_vae1", epoch=2)
    init = _init(jc, _seed_keys([0, 1, 2, 2]))
    epochs = _epochs(JaxEnsembleKeys("seed", tc, 4, [0, 1, 2, 2]), tc, N, 2)
    common = dict(trainer="train_seed_ensemble", cfg=_kw(tc), data=_data(),
                  params=init, epochs=epochs, kwargs=dict(seeds=[0, 1, 2]))
    extra = {
        "straight": ("ensemble", dict(common, root=str(tmp / "a"),
                                      runs=[(2, 1, False)])),
        "resumed": ("ensemble", dict(common, root=str(tmp / "b"),
                                     runs=[(1, 1, False), (2, 1, True)])),
    }
    for name, (entry, flags) in ENTRY_PATHS.items():
        extra[name] = ("entry", dict(
            module=entry,
            workdir=str(_workdir(tmp / name.replace(" ", "_"), name)),
            argv=["-device", "cpu", *flags, *FLAGS]))
    names = list(cases) + list(extra)
    got = worker.spawn([job for job, _ in cases.values()]
                       + list(extra.values()), 2, tmp / "pg")
    return ([dict(zip(names, r)) for r in got],
            {k: w for k, (_, w) in cases.items()}, tmp)


@pytest.mark.parametrize("name", ["seed", "split", "alpha", "alpha_seed",
                                  "sweep"])
def test_ensemble_on_dp_2_matches_jax_s_padded_run(ranks, name):
    """3 replicas padded to 4 on dp = 2: on both ranks the 3 real rows of
    the history and the parameters are JAX's mesh run's."""
    got, want, _ = ranks
    want_p, want_h = want[name][:2]
    for rank in got:
        res = rank[name]
        assert res["hist"].shape == want_h.shape == (3, EPOCHS)
        np.testing.assert_allclose(res["hist"], want_h, rtol=HIST_RTOL)
        _close(tckpt.params_from_jax(res["params"], "cpu"), want_p,
               EPOCHS * STEPS_PER_EPOCH)
        if name == "sweep":
            assert res["rows"] == want[name][2]


def test_early_stopping_sees_every_padded_row_on_both_ranks(ranks):
    """The gathered losses of all 4 rows reach each rank's tracker: JAX's
    best losses, the same stop at epoch 4 and the first check's
    parameters."""
    got, want, _ = ranks
    want_p, want_h, best = want["early_stop"]
    for rank in got:
        res = rank["early_stop"]
        assert res["hist"].shape == want_h.shape == (3, 4)
        np.testing.assert_allclose(res["hist"], want_h, rtol=HIST_RTOL)
        np.testing.assert_allclose(res["best"], best, rtol=1e-5)
        assert len(res["best"]) == 4
        _close(tckpt.params_from_jax(res["params"], "cpu"), want_p,
               2 * STEPS_PER_EPOCH)


def test_a_resumed_mesh_ensemble_equals_the_straight_one(ranks):
    """Stopped after epoch 1 and resumed on dp = 2: bit for bit the
    straight run; rank 0 alone writes the resume file, which holds the 4
    padded rows as JAX's does."""
    got, _, tmp = ranks
    for rank in got:
        np.testing.assert_array_equal(rank["resumed"]["hist"][:, -1],
                                      rank["straight"]["hist"][:, -1])
        for k, v in rank["straight"]["params"].items():
            np.testing.assert_array_equal(rank["resumed"]["params"][k], v)
    # straight: epochs 1 and 2; resumed: epoch 2 after the resume
    assert got[0]["straight"]["saves"]["save_resume"] == 2
    assert got[0]["resumed"]["saves"]["save_resume"] == 1
    assert got[1]["straight"]["saves"]["save_resume"] == 0
    assert got[1]["resumed"]["saves"]["save_resume"] == 0
    saved = torch.load(tmp / "a" / "ens.resume.pt", weights_only=False)
    assert all(v.shape[0] == 4 for k, v in saved.items()
               if k.startswith("params/"))


@pytest.mark.parametrize("path", sorted(ENTRY_PATHS))
def test_entry_point_ensemble_on_mesh_2_1_writes_what_jax_writes(
        ranks, monkeypatch, capsys, path, tmp_path):
    """The entry point on 2 ranks with -mesh 2,1 and the JAX package's
    with the same flags on a dp = 2 mesh: the same files (checkpoints,
    `.seed{s}` siblings, the padded ensemble's resume file, artifacts,
    metrics), each written once by rank 0, and the same banners with the
    mesh tag, printed by rank 0 alone."""
    got, _, tmp = ranks
    entry, flags = ENTRY_PATHS[path]
    r0, r1 = got[0][path], got[1][path]
    assert r0["rc"] == r1["rc"] == 0
    assert r1["out"] == "" and not any(r1["writes"].values())
    jax_dir = _workdir(tmp_path / "jax", path)
    _run_jax(monkeypatch, jax_dir, entry, [*flags, *FLAGS])
    jax_out = capsys.readouterr().out
    port_dir = tmp / path.replace(" ", "_")
    files = _written(port_dir)
    assert files == _written(jax_dir)
    ckpts = [f for f in files if f.endswith((".pt", ".seed1", ".seed2"))
             and "/checkpoints/" in f and "resume" not in f]
    assert ckpts and r0["writes"]["save"] == len(ckpts)
    assert r0["writes"]["save_resume"] >= 1
    banners = [ln for ln in jax_out.splitlines()
               if ln.startswith(("===", "[")) and "Devices" not in ln]
    assert banners and banners == [
        ln for ln in r0["out"].splitlines()
        if ln.startswith(("===", "[")) and "Device" not in ln]
    assert any("mesh={'dp': 2, 'tp': 1}" in ln for ln in banners)

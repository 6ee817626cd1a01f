"""The port's multi-device training (`config.mesh_shape`/`resolve_mesh`,
`parallel/mesh`, `parallel/train_parallel`) against the JAX package's on
its 8 virtual CPU devices (tests/conftest.py).

The port runs on gloo ranks started by `torch_dist_worker.spawn` (two
spawns a module: 2 ranks, then 4); the ranks import no JAX. The parent makes
JAX's parameters and the draws of JAX's key schedule (`JaxShardedKeyStream`:
JaxKeyStream's with key0 = PRNGKey(seed) and epoch + 1,
train_parallel.py:175-217) at the global batch's shapes, and the ranks
replay them (`torch_dist_worker.Recorded`), each taking its rows."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.data import loaders as jloaders
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu.models import get_model as jget_model
from vae_posterior_consistency_tpu.parallel import mesh as jmesh
from vae_posterior_consistency_tpu.parallel import train_parallel as jtp
from vae_posterior_consistency_tpu.utils.early_stopping import (
    EarlyStopping as JEarlyStopping,
)
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.engine import train as ttrain
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.parallel import mesh as tmesh
from vae_posterior_consistency_tpu_torch.parallel import multihost

import torch_dist_worker as worker
from test_torch_resume import JaxValKeys
from test_torch_train import JaxKeyStream, model_noise

#: the tiny training set of the loop tests: 20 rows of 6 features at batch
#: 8 on dp = 2 (3 steps an epoch, 4 rows wrap-padded), 2 epochs
N, D, BATCH, EPOCHS = 20, 6, 8, 2
#: a width at which the gauss family has leaves the tp rule shards (its
#: first and last layers, 130 >= TP_MIN_DIM wide)
WIDE = 130


class JaxShardedKeyStream(JaxKeyStream):
    """JAX's `train_sharded` keys: epoch e from fold_in(key0, e + 1)."""

    def __call__(self, kind, epoch, step, shape):
        return super().__call__(kind, epoch + 1, step, shape)


def step_requests(tc, B, d):
    """The draws of one step at global batch B: (kind, shape), in order
    (`engine/train.draw_step`)."""
    reqs = []
    if tc.info.regularized:
        reqs.append(("mask_p", (B, d)))
    elif tc.info.with_drop:
        reqs.append(("drop", (2, B, d)))
    return reqs + list(get_model(tc).train_noise(tc, B, d).items())


def record(stream, requests):
    """{(kind, epoch, step, shape): numpy draw} of `stream`."""
    return {(kind, e, s, tuple(shape)): stream(kind, e, s, shape).numpy()
            for kind, e, s, shape in requests}


def loop_draws(stream, tc, n, d, dp, epochs):
    """Every draw of `epochs` epochs of `train_sharded` on n rows."""
    bsz = max(min(tc.batch_size, n) // dp * dp, dp)
    reqs = []
    for e in range(epochs):
        reqs.append(("perm", e, 0, (n,)))
        reqs += [(k, e, s, shape) for s in range(math.ceil(n / bsz))
                 for k, shape in step_requests(tc, bsz, d)]
    return record(stream, reqs)


def _data(n=N, d=D, n_test=0, seed=1):
    rng = np.random.default_rng(seed)

    def draw(rows):
        return (rng.uniform(0.0, 1.0, (rows, d)).astype(np.float32),
                (rng.random((rows, d)) < 0.7).astype(np.float32))

    x, m = draw(n)
    return (x, m) + (draw(n_test) if n_test else ())


def _jds(data):
    def split(x, m, stage):
        return jloaders.Split(jnp.asarray(x), jnp.asarray(m), stage)

    return jloaders.Dataset(split(*data[:2], "train"),
                            split(*data[2:], "test") if len(data) > 2
                            else None, data[0].shape[1])


def _jmesh(dp, tp):
    return jmesh.make_mesh(jax.devices()[:dp * tp], dp=dp, tp=tp)


def _flat(params):
    return {k: np.asarray(v) for k, v in jckpt._flatten(
        jax.device_get(params)).items()}


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

SPECS = ["", "auto", "1,1", "2,1", "4,2", "dp:2"]


def _outcome(fn):
    try:
        return fn()
    except Exception as exc:  # the outcome compared is the exception
        return exc


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("spec", SPECS)
def test_mesh_resolves_as_in_jax(monkeypatch, spec, n):
    """`mesh_shape` and `resolve_mesh` against JAX's `resolve_mesh` with n
    devices: the same None, (dp, tp), or exception and message. One
    deliberate divergence (ROADMAP C.4.21): where JAX takes fewer than all
    n devices, the port, whose every rank must join the mesh, raises
    ValueError naming both counts. A one-device mesh (`1,1` on 1) is built
    on a world-size-1 group made for it, destroyed after."""
    devices = jax.devices()[:n]
    monkeypatch.setattr(jax, "devices", lambda *a, **kw: devices)
    want = _outcome(lambda: jcfg.resolve_mesh(jcfg.RunConfig(mesh=spec)))
    monkeypatch.setattr(tcfg, "device_count", lambda: n)
    got = _outcome(lambda: tcfg.mesh_shape(spec, tcfg.device_count()))
    if isinstance(want, Exception):
        assert type(got) is type(want) and str(got) == str(want)
    elif want is None:
        assert got is None
        assert tcfg.resolve_mesh(tcfg.RunConfig(mesh=spec)) is None
    elif want.devices.size < n:
        assert isinstance(got, ValueError)
        assert f"spans {want.devices.size} devices" in str(got)
        assert f"has {n} ranks" in str(got)
    else:
        assert got == (want.shape["dp"], want.shape["tp"])
    if n == 1 and spec == "1,1":
        try:
            mesh = tcfg.resolve_mesh(tcfg.RunConfig(mesh=spec), device="cpu")
            assert dict(mesh.shape) == {"dp": 1, "tp": 1}
            assert str(dict(mesh.shape)) == "{'dp': 1, 'tp': 1}"
            assert torch.distributed.get_backend() == "gloo"
        finally:
            multihost.shutdown()
        assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("n", range(1, 9))
def test_factor_devices_is_jax_s(n):
    assert tmesh.factor_devices(n) == jmesh.factor_devices(n)


def _placements(spec, ndim):
    """A JAX PartitionSpec as the port's [dp, tp] placements."""
    from torch.distributed.tensor import Replicate, Shard

    dims = [i for i in range(ndim) if i < len(spec) and spec[i] == "tp"]
    assert all(s in (None, "tp") for s in spec)
    return [Replicate(), Shard(dims[0]) if dims else Replicate()]


@pytest.mark.parametrize("kw,obs_dim", [
    (dict(vae_type="reg_vae1", hid_dim=256), 13),
    (dict(vae_type="reg_EDDI1", data_type="mnist"), 784)])
def test_param_sharding_rule_is_jax_s_leaf_for_leaf(kw, obs_dim):
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    mesh = _jmesh(4, 2)
    want = {k: jmesh.param_sharding_rule(v, mesh).spec
            for k, v in jckpt._flatten(jget_model(jc).init(
                jax.random.PRNGKey(0), jc, obs_dim)).items()}
    params = get_model(tc).init(torch.Generator().manual_seed(0), tc,
                                obs_dim, device="cpu")
    got = tmesh.params_shardings(params, None)
    assert sorted(got) == sorted(want)
    flat = tckpt.flatten(params)
    for k, placements in got.items():
        assert placements == _placements(want[k], flat[k].dim()), k
    # the UCI gauss layers are 100 and 50 wide whatever hid_dim is, so at
    # the wine width no leaf reaches TP_MIN_DIM; at the MNIST width most do
    sharded = [k for k, pl in got.items() if pl[1].is_shard()]
    assert (len(sharded) > len(got) // 2) if obs_dim > 128 else not sharded


# ---------------------------------------------------------------------------
# the ranks' runs, two spawns
# ---------------------------------------------------------------------------

def _step_case(dp, tp, d=D):
    """JAX's sharded step (tests/test_parallel.py:39-70) on a (dp, tp)
    mesh at d features, and the port job replaying its draws."""
    kw = dict(vae_type="reg_vae1", latent_dim=4)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    model = jget_model(jc)
    B = 16
    params = model.init(jax.random.PRNGKey(0), jc, d)
    x = jax.random.uniform(jax.random.PRNGKey(1), (B, d))
    m = (jax.random.uniform(jax.random.PRNGKey(2), (B, d)) < 0.7).astype(
        jnp.float32)
    step_key = jax.random.PRNGKey(3)
    flat = _flat(params)
    sharded_step, shard_inputs, tx = jtp.make_parallel_train_step(
        jc, _jmesh(dp, tp), model, params)
    sp, so, sx, sm = shard_inputs(params, tx.init(params), x, m)
    p2, _, loss = sharded_step(sp, so, sx, sm, step_key, jnp.float32(1.0))
    k_mask, k_model = jax.random.split(step_key)

    def stream(kind, epoch, step, shape):
        if kind == "mask_p":
            return torch.from_numpy(np.array(
                jax.random.uniform(k_mask, shape)))
        return model_noise(k_model, tc, kind, shape)

    draws = record(stream, [(k, 0, 0, shape)
                            for k, shape in step_requests(tc, B, d)])
    job = ("step", dict(cfg=kw, mesh_shape=(dp, tp), params=flat,
                        x=np.asarray(x), mask=np.asarray(m), draws=draws))
    return job, {"loss": float(loss), "params": _flat(p2), "init": flat}


def _train_case(vae_type, dp, tp, root=None, d=D, **extra):
    """JAX's `train_sharded` on the tiny set (d features), and the port
    job replaying its keys from JAX's initial parameters."""
    kw = dict(vae_type=vae_type, epoch=EPOCHS, batch_size=BATCH, seed=3,
              **extra)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    data = _data(d=d)
    want_params, want_hist = jtp.train_sharded(_jds(data), jc,
                                               _jmesh(dp, tp))
    key0 = jax.random.PRNGKey(jc.seed)
    init = _flat(jget_model(jc).init(key0, jc, d))
    draws = loop_draws(JaxShardedKeyStream(key0, tc), tc, N, d, dp, EPOCHS)
    job = ("train", dict(cfg=kw, mesh_shape=(dp, tp), data=data,
                         params=init, draws=draws, root=root))
    return job, {"hist": np.asarray(want_hist),
                 "params": _flat(want_params)}


def _early_stop_case():
    """JAX's early-stopping loop (tests/test_parallel.py:1255-1279):
    patience 1, delta 1e9, checks every 2 epochs on the test split, so it
    stops at epoch 4 with the first check's parameters."""
    kw = dict(vae_type="reg_vae1", epoch=20, batch_size=BATCH, seed=3,
              latent_dim=4)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    data = _data(n_test=7)
    es = JEarlyStopping(patience=1, delta=1e9)
    want_params, want_hist = jtp.train_sharded(
        _jds(data), jc, _jmesh(2, 1), chunk_epochs=2, early_stopping=es)
    key0 = jax.random.PRNGKey(jc.seed)
    init = _flat(jget_model(jc).init(key0, jc, D))
    draws = loop_draws(JaxShardedKeyStream(key0, tc), tc, N, D, 2, 4)
    vkeys = JaxValKeys(jax.random.split(key0)[1], tc)
    val = record(vkeys, [(k, ttrain.VAL_EPOCH, 0, shape)
                         for k, shape in step_requests(tc, 7, D)])
    job = ("train", dict(cfg=kw, mesh_shape=(2, 1), data=data, params=init,
                         draws=draws, val_draws=val, patience=1,
                         chunk_epochs=2))
    return job, {"hist": np.asarray(want_hist),
                 "params": _flat(want_params)}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The (2, 1) runs: the step, the loops of reg_vae1 (checkpoint
    written) and reg_EDDI1, early stopping, and the resume pair."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    cases = {
        "step": _step_case(2, 1),
        "step_wide": _step_case(2, 1, d=WIDE),
        "reg_vae1": _train_case("reg_vae1", 2, 1, root=str(tmp / "ck")),
        "reg_EDDI1": _train_case("reg_EDDI1", 2, 1),
        "early_stop": _early_stop_case(),
    }
    kw = dict(vae_type="reg_vae1", epoch=2, batch_size=BATCH, seed=5)
    resume = {
        "straight": ("train", dict(cfg=kw, mesh_shape=(2, 1), data=_data(),
                                   root=str(tmp / "a"))),
        "resumed": ("train", dict(cfg=kw, mesh_shape=(2, 1), data=_data(),
                                  root=str(tmp / "b"),
                                  runs=[(1, 1, False), (2, 1, True)])),
    }
    extra = dict(resume, host_data=("host_data", dict(rows=3)))
    jobs = [job for job, _ in cases.values()] + list(extra.values())
    names = list(cases) + list(extra)
    ranks = worker.spawn(jobs, 2, tmp / "pg")
    got = [dict(zip(names, r)) for r in ranks]
    want = {k: w for k, (_, w) in cases.items()}
    return got, want, tmp


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The (2, 2) runs (the step, the reg_vae1 loop, checkpoint written,
    the loop at a width whose leaves tp shards, and a seed ensemble), 3
    rows on dp = 4, and the dry run at hid_dim 256."""
    tmp = tmp_path_factory.mktemp("four_ranks")
    cases = {
        "step": _step_case(2, 2),
        "step_wide": _step_case(2, 2, d=WIDE),
        "reg_vae1": _train_case("reg_vae1", 2, 2, root=str(tmp / "ck")),
        "wide": _train_case("reg_vae1", 2, 2, d=WIDE),
        "seed_ensemble": _seed_ensemble_case(2, 2, str(tmp / "ens")),
    }
    x3 = np.random.default_rng(0).uniform(0, 1, (3, 5)).astype(np.float32)
    extra = {
        "tiny": ("train", dict(
            cfg=dict(vae_type="reg_vae1", epoch=2, batch_size=64,
                     latent_dim=2),
            mesh_shape=(4, 1), data=(x3, np.ones_like(x3)))),
        "dryrun": ("dryrun", dict(
            cfg=dict(vae_type="reg_vae1", hid_dim=256, latent_dim=4),
            mesh_shape=(2, 2))),
    }
    jobs = [job for job, _ in cases.values()] + list(extra.values())
    names = list(cases) + list(extra)
    ranks = worker.spawn(jobs, 4, tmp / "pg")
    got = [dict(zip(names, r)) for r in ranks]
    want = {k: w for k, (_, w) in cases.items()}
    return got, want, tmp


def _seed_ensemble_case(dp, tp, root):
    """JAX's seed ensemble of 3 replicas on a (dp, tp) mesh (padded to 4
    on dp = 2) for one epoch, and the port job from JAX's padded init
    under its keys, its resume file written into `root`."""
    from vae_posterior_consistency_tpu.parallel import sweep as jsweep
    from test_torch_mesh_sweep import _epochs, _init, _kw
    from test_torch_sweep import JaxEnsembleKeys, _cfgs, _seed_keys

    jc, tc = _cfgs("reg_vae1", epoch=1)
    data = _data()
    want_p, want_h = jsweep.train_seed_ensemble(_jds(data), jc, [0, 1, 2],
                                                mesh=_jmesh(dp, tp))
    run_seeds = [0, 1, 2, 2]
    job = ("ensemble", dict(
        trainer="train_seed_ensemble", cfg=_kw(tc), data=data,
        params=_init(jc, _seed_keys(run_seeds)),
        epochs=_epochs(JaxEnsembleKeys("seed", tc, 4, run_seeds), tc, N, 1),
        kwargs=dict(seeds=[0, 1, 2]), mesh_shape=(dp, tp), root=root,
        runs=[(1, 1, False)]))
    return job, {"hist": np.asarray(want_h), "params": want_p}


def _ranks(request, world):
    return request.getfixturevalue({2: "two_ranks", 4: "four_ranks"}[world])


# ---------------------------------------------------------------------------
# one step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,dp,tp,name", [
    (2, 2, 1, "step"), (4, 2, 2, "step"), (2, 2, 1, "step_wide"),
    (4, 2, 2, "step_wide")])
def test_sharded_step_matches_jax_s(request, world, dp, tp, name):
    """The sharded step against JAX's on the same mesh shape, parameters,
    batch and draws, on every rank: at JAX's test width (6 features) the
    loss within 1e-4 and the parameters atol 1e-5 (JAX's own bounds,
    tests/test_parallel.py:68-70); at 130 features, where tp shards the
    first and last layers, the loss sums 130/6 times as many cells, so its
    bound is 1e-4 * 130/6. Each rank stores only its tp shard of each leaf
    the rule shards."""
    got, want, _ = _ranks(request, world)
    w = want[name]
    width = w["init"]["decoder/layer2/b"].shape[0]
    for rank in got:
        r = rank[name]
        assert abs(r["loss"] - w["loss"]) < 1e-4 * max(width / D, 1)
        assert sorted(r["params"]) == sorted(w["params"])
        for k, v in r["params"].items():
            np.testing.assert_allclose(v, w["params"][k], atol=1e-5,
                                       err_msg=k)
        for k, shape in r["local"].items():
            full = w["init"][k].shape
            rule = tmesh.param_sharding_rule(torch.empty(full), None)[1]
            want_shape = list(full)
            if rule.is_shard():
                want_shape[rule.dim] //= tp
            assert list(shape) == want_shape, k
            # Adam's moments are stored as their parameter is
            for m in ("exp_avg", "exp_avg_sq"):
                assert list(r["moments"][f"{k}/{m}"]) == want_shape
    if tp > 1 and width > tmesh.TP_MIN_DIM:
        assert any(list(s) != list(w["init"][k].shape)
                   for k, s in got[0][name]["local"].items())


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def _close_to_jax(got, want, steps):
    """`test_torch_train.train_against_jax`'s bound on final weights:
    2 * lr * steps on any weight, at most one in a thousand over 1e-5."""
    assert sorted(got) == sorted(want)
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in got])
    assert diffs.max() <= 2 * ttrain.LEARNING_RATE * steps, diffs.max()
    assert np.mean(diffs > 1e-5) <= 1e-3, np.sort(diffs)[-10:]


@pytest.mark.parametrize("world,name", [
    (2, "reg_vae1"), (4, "reg_vae1"), (4, "wide"), (2, "reg_EDDI1")])
def test_train_sharded_matches_jax_s_under_its_keys(request, world, name):
    """`train_sharded` on (2, 1) and (2, 2) ranks against JAX's on the same
    mesh shape, from JAX's initial parameters under JAX's key schedule:
    the history rtol 1e-4, the weights within train_against_jax's bound,
    the same on every rank."""
    got, want, _ = _ranks(request, world)
    for rank in got:
        np.testing.assert_allclose(rank[name]["hist"], want[name]["hist"],
                                   rtol=1e-4)
        _close_to_jax(rank[name]["params"], want[name]["params"],
                      EPOCHS * math.ceil(N / BATCH))


@pytest.mark.parametrize("world", [2, 4])
def test_checkpoint_is_written_once_by_rank_0_with_jax_keys(request, world):
    got, want, tmp = _ranks(request, world)
    assert [r["reg_vae1"]["saves"]["save"] for r in got] == [1] + [0] * (
        world - 1)
    assert all(r["reg_vae1"]["saves"]["save_resume"] == 0 for r in got)
    cfg = jcfg.RunConfig(vae_type="reg_vae1", seed=3)
    path = jckpt.checkpoint_path(cfg, str(tmp / "ck"))
    saved = torch.load(path, weights_only=False)
    assert sorted(saved) == sorted(want["reg_vae1"]["params"])
    for k, v in saved.items():
        np.testing.assert_array_equal(np.asarray(v),
                                      got[0]["reg_vae1"]["params"][k])


def test_three_rows_train_on_dp_4(four_ranks):
    """n < dp: the padded epoch tiles the permutation
    (tests/test_parallel.py:110-127)."""
    for rank in four_ranks[0]:
        hist = rank["tiny"]["hist"]
        assert hist.shape == (2,) and np.isfinite(hist).all()


def test_dryrun_train_step_is_finite_on_a_2x2_mesh(four_ranks):
    losses = [r["dryrun"]["loss"] for r in four_ranks[0]]
    assert np.isfinite(losses).all() and len(set(losses)) == 1


def test_seed_ensemble_on_a_2x2_mesh_matches_jax_s(four_ranks):
    """3 seed replicas padded to 4 on (dp, tp) = (2, 2): every rank, the
    tp ranks repeating their dp row's replicas, ends with JAX's history
    and parameters; rank 0 alone writes the resume file."""
    from test_torch_resume import HIST_RTOL
    from test_torch_sweep import STEPS_PER_EPOCH, _close

    got, want, _ = four_ranks
    w = want["seed_ensemble"]
    for rank in got:
        r = rank["seed_ensemble"]
        assert r["hist"].shape == (3, 1)
        np.testing.assert_allclose(r["hist"], w["hist"], rtol=HIST_RTOL)
        _close(tckpt.params_from_jax(r["params"], "cpu"), w["params"],
               STEPS_PER_EPOCH)
    saves = [rank["seed_ensemble"]["saves"]["save_resume"] for rank in got]
    assert saves == [1, 0, 0, 0]


def test_resumed_run_equals_the_straight_run_bit_for_bit(two_ranks):
    """1 epoch with checkpoint_every=1, then resume=True to 2, against 2
    straight (the default noise: the port's generator reseeds each epoch):
    the same parameters bit for bit, the last epoch's loss too; one resume
    file write a boundary, by rank 0."""
    got, _, tmp = two_ranks
    for rank in got:
        a, b = rank["straight"], rank["resumed"]
        assert b["hist"].tolist() == a["hist"][1:].tolist()
        assert sorted(a["params"]) == sorted(b["params"])
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])
    assert [r["resumed"]["saves"]["save_resume"] for r in got] == [1, 0]
    path = tckpt.checkpoint_path(
        tcfg.RunConfig(vae_type="reg_vae1", seed=5), str(tmp / "b"))
    assert int(torch.load(path + ".resume.pt", weights_only=False)
               ["epoch"]) == 2


def test_early_stopping_stops_at_jax_s_epoch(two_ranks):
    """Patience 1 with delta 1e9: JAX stops after its second check (epoch
    4) and keeps the first check's parameters; the port, rank 0 deciding,
    stops there on both ranks with the same history and parameters."""
    got, want, _ = two_ranks
    w = want["early_stop"]
    assert w["hist"].shape == (4,)
    for rank in got:
        r = rank["early_stop"]
        assert r["hist"].shape == (4,)
        np.testing.assert_allclose(r["hist"], w["hist"], rtol=1e-4)
        _close_to_jax(r["params"], w["params"], 2 * math.ceil(N / BATCH))


def test_shard_host_data_assembles_the_global_batch(two_ranks):
    """Each rank's 3 rows become its shard of the dp-sharded [6, 3] batch;
    rank 0 alone is the coordinator."""
    got = [r["host_data"] for r in two_ranks[0]]
    table = np.arange(18, dtype=np.float32).reshape(6, 3)
    for rank, r in enumerate(got):
        assert r["shape"] == (6, 3)
        np.testing.assert_array_equal(r["local"], table[3 * rank:3 * rank + 3])
        np.testing.assert_array_equal(r["full"], table)
    assert [r["coordinator"] for r in got] == [True, False]

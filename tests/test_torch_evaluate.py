"""The port's MCAR evaluation against the JAX package: `eval_vae` fed a noise
source that replays JAX's evaluation key stream gives JAX's metrics on both
splits from the same parameters; the artifacts it writes have JAX's names
and contents; `completion` gives JAX's samples."""

import json
import os

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
from vae_posterior_consistency_tpu.engine import inference as jinf
from vae_posterior_consistency_tpu.models import get_model as jget_model
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.data import loaders as tloaders
from vae_posterior_consistency_tpu_torch.engine import artifacts as tart
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.engine import evaluate as teval
from vae_posterior_consistency_tpu_torch.engine import inference as tinf
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.ops import _kernel

#: the port's eval against JAX's under the same key stream: the same float32
#: arithmetic in another summation order
RTOL = 1e-5
#: the MNIST-width loss terms sum 784 cells per row after 500-wide layers
MNIST_LOSS_RTOL = 1e-4


def _t(a):
    return torch.tensor(np.asarray(a))


class JaxEvalKeys:
    """Replays the JAX evaluator's key stream as a port noise source
    (engine/evaluate.py:95-113, 201-203): keys[m] = fold_in(key, m), split
    into (kperm, kbatch); the batch key fold_in(kbatch, s), split into
    (k_maskp, k_model); the batch's mask_p uniforms from k_maskp
    (ops/masks.sub_mask); eps from k_model, which follows the family of
    `cfg`: normal(k_model) for gauss (its forward's reparameterize) and the
    flow (nn/flow.py:185); MIWAE splits it into (kq, kp) and draws
    [B, K, L] from kq, and from kp for a regularized type's p branch
    (miwae.py:137, 61-69); notMIWAE draws from kq alone (notmiwae.py:191).
    Without `cfg`, the gauss and flow stream."""

    def __init__(self, key, cfg=None):
        self.key = key
        self.family = "gauss" if cfg is None else get_model(cfg).name
        self.regularized = cfg is not None and cfg.info.regularized

    def __call__(self, kind, rep, step, shape):
        kperm, kbatch = jax.random.split(jax.random.fold_in(self.key, rep))
        if kind == "perm":
            return _t(jax.random.permutation(kperm, shape[0])).long()
        k_maskp, k_model = jax.random.split(jax.random.fold_in(kbatch, step))
        if kind == "mask_p":
            return _t(jax.random.uniform(k_maskp, shape))
        assert kind == "eps", kind
        return self.eps(k_model, shape)

    def eps(self, k_model, shape):
        """The eps the family's JAX `eval_step` draws from its key."""
        if self.family in ("gauss", "flow"):
            return _t(jax.random.normal(k_model, shape))
        kq, kp = jax.random.split(k_model)
        if self.family == "miwae" and self.regularized:
            return _t(jnp.stack([jax.random.normal(k, shape[1:])
                                 for k in (kq, kp)]))
        return _t(jax.random.normal(kq, shape))


def _datasets(x_tr, m_tr, x_te, m_te):
    def jsplit(x, m, stage):
        return jloaders.Split(jnp.asarray(x), jnp.asarray(m), stage)

    def tsplit(x, m, stage):
        return tloaders.Split(torch.from_numpy(x), torch.from_numpy(m), stage)

    D = x_tr.shape[1]
    return (jloaders.Dataset(jsplit(x_tr, m_tr, "train"),
                             jsplit(x_te, m_te, "test"), D),
            tloaders.Dataset(tsplit(x_tr, m_tr, "train"),
                             tsplit(x_te, m_te, "test"), D))


def _tiny(seed, D=6):
    """Train: 20 rows, masks at 70%, 3 batches of 8 with 4 rows wrap-padded.
    Test: 9 rows, one with holes and eight fully observed, so of its two
    batches of 8 one has no missing cell among its valid rows (its RMSE is
    0 over a denominator clamped to 1), and when the holed row is also one
    of the 7 padded rows of the last batch, its holes weigh 0."""
    rng = np.random.default_rng(seed)
    x_tr = rng.uniform(0.0, 1.0, (20, D)).astype(np.float32)
    m_tr = (rng.random((20, D)) < 0.7).astype(np.float32)
    x_te = rng.uniform(0.0, 1.0, (9, D)).astype(np.float32)
    m_te = np.ones((9, D), np.float32)
    m_te[4, [1, 3]] = 0.0
    return _datasets(x_tr, m_tr, x_te, m_te)


def _params(jc, obs_dim, seed=7):
    jparams = jget_model(jc).init(jax.random.PRNGKey(seed), jc, obs_dim)
    return jparams, tckpt.params_from_jax(jckpt._flatten(jparams), "cpu")


def _both(jc, tc, jds, tds, obs_dim, **kw):
    jparams, tparams = _params(jc, obs_dim)
    want = jeval.eval_vae(jds, jc, params=jparams, **kw)
    got = teval.eval_vae(tds, tc, params=tparams,
                         noise=JaxEvalKeys(jax.random.PRNGKey(jc.seed + 1)),
                         device="cpu", **kw)
    return got, want


@pytest.mark.parametrize("vae_type", ["reg_vae1", "vanilla_EDDI1",
                                      "reg_vae1_mask_augm"])
def test_eval_vae_matches_jax_under_the_replayed_key_stream(vae_type):
    kw = dict(vae_type=vae_type, M=2, batch_size=8, seed=3, missing_rate=30)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    jds, tds = _tiny(seed=5)
    got, want = _both(jc, tc, jds, tds, 6, save=False)
    assert list(got) == list(want) == ["train", "test"]
    for stage in want:
        assert list(got[stage]) == list(want[stage])  # order too
        for name, value in want[stage].items():
            np.testing.assert_allclose(got[stage][name], value, rtol=RTOL,
                                       err_msg=f"{stage} {name}")
    assert got["test"]["rmse"] > 0.0
    assert all(np.isfinite(v) for s in got.values() for v in s.values())


def test_both_splits_start_from_the_same_keys():
    """The default source restarts from cfg.seed + 1 for each split: a
    split evaluated twice gives the same metrics, as in JAX."""
    tc = tcfg.RunConfig(vae_type="reg_vae1", M=2, batch_size=8)
    _, tds = _tiny(seed=6)
    tds.test = tloaders.Split(tds.train.x, tds.train.mask, "test")
    _, tparams = _params(jcfg.RunConfig(vae_type="reg_vae1"), 6)
    res = teval.eval_vae(tds, tc, params=tparams, save=False, device="cpu")
    assert res["train"] == res["test"]


def test_eval_vae_at_mnist_width_matches_jax():
    """reg_EDDI1 at MNIST widths (D=784, trunk 500-500-200, decoder
    200-500-500) on 100 rows of each split of Data/mnist: two batches of 64
    a split, the last 36 rows and 28 padded."""
    kw = dict(vae_type="reg_EDDI1", data_type="mnist", M=1, batch_size=64,
              missing_rate=30)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    full = tloaders.data_loader_mnist("Data", "reg_EDDI1", 30, 64,
                                      device="cpu")
    arrays = [t[:100].numpy() for t in (full.train.x, full.train.mask,
                                        full.test.x, full.test.mask)]
    jds, tds = _datasets(*arrays)
    before = _kernel.launches.copy()
    got, want = _both(jc, tc, jds, tds, 784, save=False)
    assert _kernel.launches == before  # CPU: the plain versions
    for stage in want:
        np.testing.assert_allclose(got[stage]["rmse"], want[stage]["rmse"],
                                   rtol=RTOL, err_msg=stage)
        for name in ("loss", "negl", "negl_imp"):
            np.testing.assert_allclose(got[stage][name], want[stage][name],
                                       rtol=MNIST_LOSS_RTOL,
                                       err_msg=f"{stage} {name}")


@pytest.mark.parametrize("vae_type", ["reg_vae1", "vanilla_vae2_mask_augm",
                                      "reg_EDDI3", "vanilla_EDDI1_with_drop"])
@pytest.mark.parametrize("stage", ["train", "test"])
def test_eval_vae_paths_match_jax(vae_type, stage):
    kw = dict(vae_type=vae_type, missing_rate=30, alpha=0.5,
              p_missingness=10, reg_type="ml_reg", data_type="mnist")
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    assert (tart.eval_vae_paths(tc, stage, "root")
            == jart.eval_vae_paths(jc, stage, "root"))
    assert tart.strip_digits(vae_type) == jart.strip_digits(vae_type)


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, root)] = path
    return out


@pytest.mark.parametrize("vae_type", ["vanilla_vae1", "reg_vae1"])
def test_saved_artifacts_match_jax(tmp_path, vae_type):
    kw = dict(vae_type=vae_type, M=2, batch_size=8, missing_rate=30)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    jds, tds = _tiny(seed=8)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jparams, tparams = _params(jc, 6)
    jeval.eval_vae(jds, jc, params=jparams, experiments_root=jroot)
    teval.eval_vae(tds, tc, params=tparams, experiments_root=troot,
                   noise=JaxEvalKeys(jax.random.PRNGKey(jc.seed + 1)),
                   device="cpu")
    jfiles, tfiles = _tree(jroot), _tree(troot)
    assert sorted(tfiles) == sorted(jfiles)
    assert len(tfiles) == 9  # 4 artifacts a split and metrics.jsonl
    for rel, path in tfiles.items():
        if rel.endswith("metrics.jsonl"):
            continue
        got = torch.load(path, weights_only=False)
        want = torch.load(jfiles[rel], weights_only=False)
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
        assert got.shape == want.shape == ()
        np.testing.assert_allclose(got.item(), want.item(), rtol=RTOL,
                                   err_msg=rel)
    rel = [r for r in tfiles if r.endswith("metrics.jsonl")][0]
    recs = [[json.loads(line) for line in open(f[rel])]
            for f in (tfiles, jfiles)]
    assert len(recs[0]) == len(recs[1]) == 8
    for got, want in zip(*recs):
        assert sorted(got) == sorted(want)
        assert {k: v for k, v in got.items() if k not in ("time", "value")} \
            == {k: v for k, v in want.items() if k not in ("time", "value")}
        np.testing.assert_allclose(got["value"], want["value"], rtol=RTOL)


def test_eval_vae_loads_the_trained_checkpoint(tmp_path):
    """params=None reads the checkpoint at its reference path."""
    tc = tcfg.RunConfig(vae_type="vanilla_vae1", M=1, batch_size=8)
    _, tds = _tiny(seed=9)
    _, tparams = _params(jcfg.RunConfig(vae_type="vanilla_vae1"), 6)
    tckpt.save(tparams, tckpt.checkpoint_path(tc, str(tmp_path)))
    a = teval.eval_vae(tds, tc, experiments_root=str(tmp_path), save=False,
                       device="cpu")
    b = teval.eval_vae(tds, tc, params=tparams, save=False, device="cpu")
    assert a == b
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            teval.eval_vae(tds, tc, params=tparams, save=False)


@pytest.mark.parametrize("kw", [
    dict(vae_type="reg_vae1"), dict(vae_type="vanilla_EDDI1"),
    dict(vae_type="vanilla_MIWAE1", valid_k=7),
    dict(vae_type="reg_MIWAE1", valid_k=7),
    dict(vae_type="vanilla_notMIWAE1", valid_k=7),
    dict(vae_type="reg_flow1", flow_actnorm=True, latent_dim=4, hid_dim=16),
], ids=lambda kw: kw["vae_type"])
def test_completion_matches_jax(kw):
    """Sample m replays JAX's key split(key, M)[m] through the family's
    eval_step draws: K = valid_k importance samples a row for MIWAE and
    notMIWAE, reg_MIWAE1's p branch under the given mask_p, the flow with
    its ActNorm list of parameters."""
    jc = jcfg.RunConfig(seed=2, **kw)
    tc = tcfg.RunConfig(seed=2, **kw)
    jparams = jget_model(jc).init(jax.random.PRNGKey(7), jc, 6)
    if jc.flow_actnorm:
        from test_torch_flow_vae import _random_actnorm
        jparams = _random_actnorm(jparams, jc.latent_dim)
    tparams = tckpt.params_from_jax(jckpt._flatten(jparams), "cpu")
    rng = np.random.default_rng(11)
    x = rng.uniform(0.0, 1.0, (5, 6)).astype(np.float32)
    mask = (rng.random((5, 6)) < 0.7).astype(np.float32)
    mask_p = mask * (rng.random((5, 6)) < 0.7).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jinf.completion(jparams, jnp.asarray(x),
                                      jnp.asarray(mask), jnp.asarray(mask_p),
                                      3, jc, key=key))
    shape = get_model(tc).eval_noise(tc, 5, 6)["eps"]
    eps = {"eps": torch.stack([JaxEvalKeys(None, tc).eps(k, shape)
                               for k in jax.random.split(key, 3)])}
    args = (torch.from_numpy(x), torch.from_numpy(mask),
            torch.from_numpy(mask_p), 3, tc)
    got = tinf.completion(tparams, *args, eps=eps)
    assert got.shape == (3, 5, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)
    drawn = tinf.completion(tparams, *args)
    again = tinf.completion(tparams, *args)
    assert torch.equal(drawn, again) and drawn.shape == (3, 5, 6)
    with pytest.raises(ValueError, match="eps of shapes"):
        tinf.completion(tparams, *args, eps={"eps": eps["eps"][:2]})


# ---------------------------------------------------------------------------
# ensembles
# ---------------------------------------------------------------------------


def _stacked(jc, obs_dim, S, seed=7):
    """S replicas of JAX-initialised parameters, stacked, in both
    packages."""
    keys = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.PRNGKey(seed),
                                                   jnp.arange(S))
    jparams = jax.vmap(lambda k: jget_model(jc).init(k, jc, 6))(keys)
    return jparams, tckpt.params_from_jax(jckpt._flatten(jparams), "cpu")


def _group(vae_type, S=3, **kw):
    """S configs of one family, split digits 1..S, and their tiny datasets
    (equal sizes)."""
    base = "".join(c for c in vae_type if not c.isdigit())
    kws = [dict(vae_type=f"{base}{i + 1}", M=2, batch_size=8, seed=3,
                missing_rate=30, latent_dim=4, **kw) for i in range(S)]
    pairs = [_tiny(seed=5 + i) for i in range(S)]
    return ([jcfg.RunConfig(**k) for k in kws],
            [tcfg.RunConfig(**k) for k in kws],
            [p[0] for p in pairs], [p[1] for p in pairs])


ENSEMBLE_TYPES = [("reg_vae1", {}), ("reg_EDDI1", {}),
                  ("reg_MIWAE1", {"valid_k": 4}),
                  ("reg_notMIWAE1", {"valid_k": 4})]


@pytest.mark.parametrize("vae_type,extra", ENSEMBLE_TYPES)
def test_eval_vae_ensemble_matches_jax(vae_type, extra):
    """Three replicas on three split tables under JAX's key stream, shared
    by the replicas (PRNGKey(seed + 1)): JAX's metrics for every replica on
    both splits, at RTOL."""
    jcs, tcs, jdss, tdss = _group(vae_type, **extra)
    jparams, tparams = _stacked(jcs[0], 6, 3)
    want = jeval.eval_vae_ensemble(jdss, jcs, jparams, save=False)
    got = teval.eval_vae_ensemble(
        tdss, tcs, tparams, save=False, device="cpu",
        noise=JaxEvalKeys(jax.random.PRNGKey(jcs[0].seed + 1), tcs[0]))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert list(g) == list(w) == ["train", "test"]
        for stage in w:
            assert list(g[stage]) == list(w[stage])
            for name, value in w[stage].items():
                np.testing.assert_allclose(g[stage][name], value, rtol=RTOL,
                                           err_msg=f"{stage} {name}")


@pytest.mark.parametrize("vae_type,extra", [("reg_EDDI1", {}),
                                            ("reg_MIWAE1", {"valid_k": 4})])
def test_eval_vae_ensemble_is_the_serial_evaluator_for_each_replica(
        vae_type, extra, monkeypatch):
    """Each replica's metrics are eval_vae's for its parameters on the
    default noise, and chunking the replica axis (one replica a call)
    moves no value."""
    jcs, tcs, _, tdss = _group(vae_type, **extra)
    _, tparams = _stacked(jcs[0], 6, 3)
    whole = teval.eval_vae_ensemble(tdss, tcs, tparams, save=False,
                                    device="cpu")
    for i in range(3):
        serial = teval.eval_vae(
            tdss[i], tcs[i], params=tckpt.unflatten({
                k: v[i] for k, v in tckpt.flatten(tparams).items()}),
            save=False, device="cpu")
        assert whole[i] == serial
    monkeypatch.setattr(teval, "ENS_EVAL_ROW_BUDGET", 1)
    assert teval.eval_vae_ensemble(tdss, tcs, tparams, save=False,
                                   device="cpu") == whole


def test_eval_vae_ensemble_refusals_are_jax_s():
    jcs, tcs, jdss, tdss = _group("reg_vae1")
    jparams, tparams = _stacked(jcs[0], 6, 3)
    cases = [
        # a config differing in more than the split digit
        (lambda c: [c[0], c[1].replace(alpha=0.5), c[2]], None,
         "config-identical"),
        # a test split present for only some datasets
        (None, lambda d, pkg: [d[0], d[1], pkg.Dataset(d[2].train, None, 6)],
         "present for only 2/3"),
        # unequal sizes
        (None, lambda d, pkg: [d[0], d[1], pkg.Dataset(
            pkg.Split(d[2].train.x[:12], d[2].train.mask[:12], "train"),
            d[2].test, 6)], "identical train-split sizes"),
    ]
    for cfg_fn, data_fn, match in cases:
        for pkg_eval, pkg_loaders, cfgs, dss, params, kw in (
                (jeval, jloaders, jcs, jdss, jparams, {}),
                (teval, tloaders, tcs, tdss, tparams, {"device": "cpu"})):
            c = cfg_fn(cfgs) if cfg_fn else cfgs
            d = data_fn(dss, pkg_loaders) if data_fn else dss
            with pytest.raises(ValueError, match=match):
                pkg_eval.eval_vae_ensemble(d, c, params, save=False, **kw)


def test_eval_vae_ensemble_saves_the_rows_asked_under_jax_names(tmp_path):
    """Two seed replicas of one config with save_rows=[0]: the artifacts
    of row 0 alone, under the names JAX's evaluator writes."""
    jcs, tcs, jdss, tdss = _group("reg_vae1", S=1)
    jparams, tparams = _stacked(jcs[0], 6, 2)
    jeval.eval_vae_ensemble(jdss * 2, jcs * 2, jparams, save_rows=[0],
                            experiments_root=str(tmp_path / "jax"))
    got = teval.eval_vae_ensemble(tdss * 2, tcs * 2, tparams, save_rows=[0],
                                  experiments_root=str(tmp_path / "port"),
                                  device="cpu")
    assert set(_tree(str(tmp_path / "port"))) == set(
        _tree(str(tmp_path / "jax")))
    path = tart.eval_vae_paths(tcs[0], "test", str(tmp_path / "port"))
    assert torch.load(path["rmse"], weights_only=False).item() == (
        got[0]["test"]["rmse"])


@pytest.mark.parametrize("vae_type,extra", [("reg_vae1", {}),
                                            ("reg_notMIWAE1", {"valid_k": 4})])
def test_eval_vae_mnar_ensemble_matches_jax(tmp_path, vae_type, extra):
    """Three replicas under JAX's MNAR keys (PRNGKey(seed + 2), shared):
    JAX's [S] RMSEs at RTOL; seed 0's RMSE saved under JAX's name; the
    replica chunking moves no value."""
    from test_torch_mnar import JaxMnarKeys

    kw = dict(vae_type=vae_type, M=2, seed=3, latent_dim=4, **extra)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    jds, tds = _tiny(seed=5)
    jparams, tparams = _stacked(jc, 6, 3)
    want = jeval.eval_vae_mnar_ensemble(
        jds.train.x, jds.train.mask, jc, jparams,
        experiments_root=str(tmp_path / "jax"))
    noise = JaxMnarKeys(jax.random.PRNGKey(jc.seed + 2), tc)
    got = teval.eval_vae_mnar_ensemble(
        tds.train.x, tds.train.mask, tc, tparams, noise=noise,
        experiments_root=str(tmp_path / "port"), device="cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert set(_tree(str(tmp_path / "port"))) == set(
        _tree(str(tmp_path / "jax")))
    old = teval.ENS_EVAL_ROW_BUDGET
    try:
        teval.ENS_EVAL_ROW_BUDGET = 1
        chunked = teval.eval_vae_mnar_ensemble(
            tds.train.x, tds.train.mask, tc, tparams, noise=noise,
            save=False, device="cpu")
    finally:
        teval.ENS_EVAL_ROW_BUDGET = old
    np.testing.assert_array_equal(chunked, got)

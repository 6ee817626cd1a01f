"""The port's MIWAE family (`models/miwae.py`, its layers, the `ops/math`
helpers of the importance-weighted families, `nn/core.hardtanh`, its registry
entry, its evaluator and artifacts, its checkpoints and its parity rows)
against the JAX package: JAX-initialised parameters carried over by
`checkpoint.params_from_jax` and JAX-drawn noise give the same values,
gradients, losses and evaluation rows; two Adam steps reproduce the
`vanilla_MIWAE1` golden of tests/test_golden.py and JAX's `reg_MIWAE1`
steps; `train` under the replayed JAX key stream reproduces JAX `train`;
`eval_vae` under the replayed evaluation keys reproduces JAX `eval_vae` and
writes JAX's rmse-only artifacts; checkpoints load across both packages.

Sizes are small: 12 features, batches of at most 16 rows, at most 50
importance samples.

Tolerances. An elementwise helper is the same float32 formula in both
packages; XLA's and torch's `lgamma`, `log1p` and `exp` may round an ulp
apart, so values and gradients agree to rtol 1e-5 (atol 1e-6 for entries
near zero). A loss or an evaluation row sums 12 cells a sample after two
128-wide layers and then takes a logsumexp or a mean over K samples; the
summation order differs between the frameworks, so values agree to rtol
1e-5 and gradients to rtol 1e-5 with atol 1e-5 * max|leaf| (entries near
zero carry the rounding of their sums' largest terms), as the flow tests.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_evaluate import JaxEvalKeys, _tiny, _tree
from test_torch_train import (
    GOLDEN_RTOL,
    _jax_two_steps,
    _tiny_datasets,
    model_noise,
    train_against_jax,
)
from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.engine import artifacts as jart
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu.engine import evaluate as jeval
from vae_posterior_consistency_tpu.engine import train as jtrain
from vae_posterior_consistency_tpu.models import layers as jlayers
from vae_posterior_consistency_tpu.models import miwae as jmiwae
from vae_posterior_consistency_tpu.nn import core as jcore
from vae_posterior_consistency_tpu.ops import math as jmath
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.engine import artifacts as tart
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.engine import evaluate as teval
from vae_posterior_consistency_tpu_torch.engine import train as ttrain
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.models import layers as tlayers
from vae_posterior_consistency_tpu_torch.models import miwae as tmiwae
from vae_posterior_consistency_tpu_torch.nn import core as tcore
from vae_posterior_consistency_tpu_torch.ops import math as tmath

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
ATOL = 1e-6
#: tests/test_golden.py's pinned pair for vanilla_MIWAE1
GOLDEN_MIWAE = [2.183942, 2.160026]
D, B, L = 12, 16, 4


def _t(a):
    return torch.tensor(np.asarray(a))


def _cfgs(vae_type, **kw):
    kw = dict(vae_type=vae_type, latent_dim=L, **kw)
    return jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)


def _batch(seed, rows=B, cols=D):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (rows, cols)).astype(np.float32)
    mask = (rng.random((rows, cols)) < 0.7).astype(np.float32)
    mask_p = mask * (rng.random((rows, cols)) < 0.7).astype(np.float32)
    return x, mask, mask_p


def _assert_grads(got_leaves, want_tree, err=""):
    want = jckpt._flatten(want_tree)
    assert sorted(want) == sorted(got_leaves)
    for k, v in got_leaves.items():
        w = want[k]
        np.testing.assert_allclose(v.grad.numpy(), w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max(),
                                   err_msg=f"{err} {k}")


def _leaves(jparams):
    tparams = tckpt.params_from_jax(jckpt._flatten(jparams), "cpu")
    leaves = tckpt.flatten(tparams)
    for v in leaves.values():
        v.requires_grad_(True)
    return tparams, leaves


# ---------------------------------------------------------------------------
# ops/math and nn/core helpers (both importance-weighted families)
# ---------------------------------------------------------------------------


def _math_inputs(name, rng):
    shape = (5, 7, 3)
    u = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    n = rng.normal(size=shape).astype(np.float32)
    pos = (0.05 + rng.uniform(0.0, 2.0, shape)).astype(np.float32)
    if name == "normal_logpdf_scale":
        return (u, n * 0.3, pos), {}
    if name in ("kl_diag_diag", "kl_diag_diag_sum_all"):
        lv = lambda: rng.uniform(-2.0, 1.0, shape).astype(np.float32)  # noqa
        return (n, lv(), rng.normal(size=shape).astype(np.float32), lv()), {}
    if name in ("kl_diag_diag_scale_elems", "kl_diag_diag_scale"):
        return (n, pos, rng.normal(size=shape).astype(np.float32),
                (0.05 + rng.uniform(0.0, 2.0, shape)).astype(np.float32)), {}
    if name == "bernoulli_logits_logpmf":
        logits = (3.0 * n).astype(np.float32)
        logits[0, :, 0] = 0.0  # jnp.maximum's half gradient at 0
        return (logits, (u < 0.5).astype(np.float32)), {}
    if name == "student_t_logpdf":
        df = (3.0 + rng.uniform(0.0, 20.0, shape)).astype(np.float32)
        return (u, rng.uniform(0.0, 1.0, shape).astype(np.float32),
                (0.001 + pos).astype(np.float32), df), {}
    if name in ("log_mean_exp", "softmax_neg"):
        return ((10.0 * n).astype(np.float32),), {}
    raise KeyError(name)


def _math_atol(name, args):
    """ATOL, except for the Student-t density: a difference of two lgamma
    terms of up to lgamma(13) ~ 20 and logs, whose result is near 1, so
    the frameworks' one-ulp roundings of the terms (an ulp of 20 is 1.9e-6)
    stay in it as absolute error: 4 ulps of the largest lgamma term."""
    if name != "student_t_logpdf":
        return ATOL
    df = args[3]
    return 4 * float(np.spacing(np.float32(
        np.abs(jax.scipy.special.gammaln(0.5 * (df + 1.0))).max())))


#: name -> (JAX function, port function), each of the inputs as positional
#: arguments; the reductions take the same axis in both
MATH = {
    "normal_logpdf_scale": (jmath.normal_logpdf_scale,
                            tmath.normal_logpdf_scale),
    "kl_diag_diag": (lambda *a: jmath.kl_diag_diag(*a, axis=-1),
                     lambda *a: tmath.kl_diag_diag(*a, dim=-1)),
    "kl_diag_diag_sum_all": (jmath.kl_diag_diag, tmath.kl_diag_diag),
    "kl_diag_diag_scale_elems": (jmath.kl_diag_diag_scale_elems,
                                 tmath.kl_diag_diag_scale_elems),
    "kl_diag_diag_scale": (lambda *a: jmath.kl_diag_diag_scale(*a, axis=1),
                           lambda *a: tmath.kl_diag_diag_scale(*a, dim=1)),
    "bernoulli_logits_logpmf": (jmath.bernoulli_logits_logpmf,
                                tmath.bernoulli_logits_logpmf),
    "student_t_logpdf": (jmath.student_t_logpdf, tmath.student_t_logpdf),
    "log_mean_exp": (lambda x: jmath.log_mean_exp(x, axis=1),
                     lambda x: tmath.log_mean_exp(x, dim=1)),
    "softmax_neg": (lambda x: jmath.softmax_neg(x, axis=1),
                    lambda x: tmath.softmax_neg(x, dim=1)),
}


@pytest.mark.parametrize("name", sorted(MATH))
def test_math_helper_and_its_gradients_match_jax(name):
    rng = np.random.default_rng(sorted(MATH).index(name))
    args, _ = _math_inputs(name, rng)
    jfn, tfn = MATH[name]
    want = np.asarray(jfn(*args))
    cot = rng.normal(size=want.shape).astype(np.float32)
    want_g = jax.grad(lambda *a: jnp.sum(jfn(*a) * cot),
                      argnums=tuple(range(len(args))))(*args)
    targs = [_t(a).requires_grad_() for a in args]
    got = tfn(*targs)
    atol = _math_atol(name, args)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=atol)
    got.backward(_t(cot))
    for i, (t, w) in enumerate(zip(targs, want_g)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=atol, err_msg=f"argument {i}")


def test_hardtanh_matches_jnp_clip_with_its_half_gradient_at_a_bound():
    x = np.array([-12.0, -10.0, -3.5, 0.0, 4.0, 10.0, 11.0], np.float32)
    want = np.asarray(jcore.hardtanh(x, -10.0, 10.0))
    want_g = np.asarray(jax.grad(
        lambda v: jnp.sum(jcore.hardtanh(v, -10.0, 10.0)))(x))
    tx = _t(x).requires_grad_()
    got = tcore.hardtanh(tx, -10.0, 10.0)
    got.sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(tx.grad.numpy(), want_g)
    np.testing.assert_array_equal(tx.grad.numpy(),
                                  [0.0, 0.5, 1.0, 1.0, 1.0, 0.5, 0.0])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_miwae_layers_and_their_gradients_match_jax():
    """The encoder on [B, D] (softplus scale) and the Student-t decoder on
    z [B, K, L] (sigmoid mean, softplus + 0.001 scale, softplus + 3 df)."""
    x, mask, _ = _batch(1)
    enc = jlayers.miwae_encoder_init(jax.random.PRNGKey(2), D, L)
    dec = jlayers.student_t_decoder_init(jax.random.PRNGKey(3), D, L)
    z = np.random.default_rng(4).normal(size=(B, 5, L)).astype(np.float32)
    rng = np.random.default_rng(5)
    cots = [rng.normal(size=(B, L)).astype(np.float32) for _ in range(2)]
    cots += [rng.normal(size=(B, 5, D)).astype(np.float32) for _ in range(3)]

    def jfwd(enc, dec, z):
        return (*jlayers.miwae_encoder_apply(enc, x, mask),
                *jlayers.student_t_decoder_apply(dec, z))

    want = jfwd(enc, dec, z)
    want_g = jax.grad(lambda e, d, zz: sum(
        jnp.sum(o * c) for o, c in zip(jfwd(e, d, zz), cots)),
        argnums=(0, 1, 2))(enc, dec, z)
    tenc, enc_leaves = _leaves(enc)
    tdec, dec_leaves = _leaves(dec)
    tz = _t(z).requires_grad_()
    got = (*tlayers.miwae_encoder_apply(tenc, _t(x), _t(mask)),
           *tlayers.student_t_decoder_apply(tdec, tz))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=RTOL,
                                   atol=ATOL)
    sum(torch.sum(g * _t(c)) for g, c in zip(got, cots)).backward()
    _assert_grads(enc_leaves, want_g[0], "encoder")
    _assert_grads(dec_leaves, want_g[1], "decoder")
    np.testing.assert_allclose(tz.grad.numpy(), want_g[2], rtol=RTOL,
                               atol=RTOL * np.abs(want_g[2]).max())
    assert tenc["layer2"]["w"].shape == (128, 2 * L)
    assert tdec["layer2"]["w"].shape == (128, 3 * D)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _eps(key, cfg, K, rows=B):
    """The noise JAX's miwae train_loss / eval_step draws from `key`
    (miwae.py:102, 137, 61-69): [B, K, L] from kq, and from kp for a
    regularized type's p branch."""
    shape = (2, rows, K, L) if cfg.info.regularized else (rows, K, L)
    return model_noise(key, cfg, "eps", shape)


@pytest.mark.parametrize("K", [1, 7])
@pytest.mark.parametrize("vae_type,alpha", [
    ("vanilla_MIWAE1", 1.0), ("reg_MIWAE1", 1.0), ("reg_MIWAE1", 0.5)])
def test_train_loss_and_gradients_match_jax(vae_type, alpha, K):
    jc, tc = _cfgs(vae_type, train_k=K, alpha=alpha)
    jparams = jmiwae.init(jax.random.PRNGKey(1), jc, D)
    tparams, leaves = _leaves(jparams)
    x, mask, mask_p = _batch(2)
    key = jax.random.PRNGKey(3)
    (want, want_aux), want_g = jax.jit(jax.value_and_grad(
        lambda p: jmiwae.train_loss(p, x, mask, mask_p, key, 1.0, jc),
        has_aux=True))(jparams)
    loss, aux = get_model(tc).train_loss(tparams, _t(x), _t(mask),
                                         _t(mask_p), _eps(key, tc, K), 1.0,
                                         tc)
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    assert sorted(aux) == sorted(want_aux)
    for k in want_aux:
        np.testing.assert_allclose(aux[k].item(), float(want_aux[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    loss.backward()
    _assert_grads(leaves, want_g)


@pytest.mark.parametrize("vae_type", ["vanilla_MIWAE1", "reg_MIWAE1"])
def test_eval_step_matches_jax(vae_type):
    """K = valid_k = 50 importance samples a row; the imputation is the
    softmax-weighted mean of 50 x_means."""
    K = 50
    jc, tc = _cfgs(vae_type, valid_k=K)
    jparams = jmiwae.init(jax.random.PRNGKey(4), jc, D)
    tparams = tckpt.params_from_jax(jckpt._flatten(jparams), "cpu")
    x, mask, mask_p = _batch(5, rows=9)
    key = jax.random.PRNGKey(6)
    want = jax.jit(lambda p: jmiwae.eval_step(p, x, mask, mask_p, key,
                                              jc))(jparams)
    with torch.no_grad():
        got = get_model(tc).eval_step(tparams, _t(x), _t(mask), _t(mask_p),
                                      _eps(key, tc, K, rows=9), tc)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["x_imputed"].numpy(), want["x_imputed"],
                               rtol=0, atol=ATOL)
    for name in ("row_loss", "row_negl", "row_negl_imp"):
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    if tc.info.regularized:
        assert torch.equal(got["row_negl"], got["row_loss"])
    else:
        assert tmiwae.NEGL_DIVISOR == 5000.0


def _two_steps(vae_type, **kw):
    """tests/test_golden.py's two Adam steps (latent 4, obs_dim 6, batch
    16, train_k 3, keys PRNGKey(20 + i)) through the port, and the JAX
    trainer's through `_jax_two_steps`."""
    jc = jcfg.RunConfig(vae_type=vae_type, latent_dim=4, train_k=3, **kw)
    tc = tcfg.RunConfig(vae_type=vae_type, latent_dim=4, train_k=3, **kw)
    obs_dim, rows = 6, 16
    model = get_model(tc)
    params = tckpt.unflatten({
        k: _t(v).requires_grad_(True) for k, v in jckpt._flatten(
            jmiwae.init(jax.random.PRNGKey(11), jc, obs_dim)).items()})
    x = jax.random.uniform(jax.random.PRNGKey(12), (rows, obs_dim))
    mask = (jax.random.uniform(jax.random.PRNGKey(13), (rows, obs_dim)) < 0.7
            ).astype(jnp.float32)
    mask_p = mask * (jax.random.uniform(jax.random.PRNGKey(14),
                                        (rows, obs_dim)) < 0.7
                     ).astype(jnp.float32)
    x, mask, mask_p = map(_t, (x, mask, mask_p))
    opt = ttrain.make_optimizer(params)
    losses = []
    for i in range(2):
        key = jax.random.PRNGKey(20 + i)
        drawn = {kind: model_noise(key, tc, kind, shape) for kind, shape in
                 model.train_noise(tc, rows, obs_dim).items()}
        opt.zero_grad()
        loss, _ = model.train_loss(params, x, mask, mask_p,
                                   drawn.pop("eps"), float(i + 1), tc,
                                   **drawn)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return np.array(losses), jc


def test_port_reproduces_the_vanilla_miwae_golden_two_steps():
    got, _ = _two_steps("vanilla_MIWAE1")
    np.testing.assert_allclose(got, GOLDEN_MIWAE, rtol=GOLDEN_RTOL)
    assert got[1] != got[0]


def test_reg_miwae_two_steps_match_jax_live():
    """reg_MIWAE1 has no golden: its two steps against JAX's, live."""
    got, jc = _two_steps("reg_MIWAE1")
    want = _jax_two_steps(jc, obs_dim=6, B=16)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got[1] != got[0]


@pytest.mark.parametrize("vae_type", ["reg_MIWAE1", "vanilla_MIWAE1"])
def test_train_reproduces_jax_train_under_the_miwae_key_stream(vae_type):
    train_against_jax(vae_type, latent_dim=4, train_k=5)


# ---------------------------------------------------------------------------
# the registry, the evaluator, the artifacts, the checkpoints
# ---------------------------------------------------------------------------


def test_every_family_of_the_grid_has_a_model_and_bfloat16_still_raises():
    grid = os.path.join(REPO, "Data", "imputation_args.json")
    records = [json.loads(line) for line in open(grid) if line.strip()]
    names = set()
    for record in records:
        cfg = tcfg.RunConfig.from_jsonl_record(record)
        names.add(get_model(cfg).name)
        # bfloat16, once refused, gives the same family
        bf16 = get_model(cfg.replace(compute_dtype="bfloat16"))
        assert bf16.name == get_model(cfg).name
    assert names == {"gauss", "flow", "miwae"}
    for vae_type, name in (("vanilla_MIWAE2", "miwae"),
                           ("reg_MIWAE3", "miwae"),
                           ("vanilla_notMIWAE1", "notmiwae"),
                           ("reg_notMIWAE2", "notmiwae")):
        model = get_model(tcfg.RunConfig(vae_type=vae_type))
        assert (model.name, model.eval_kind) == (name, "miwae")
        assert model.uses_p_branch == vae_type.startswith("reg_")


@pytest.mark.parametrize("vae_type", ["reg_MIWAE1", "vanilla_MIWAE1"])
def test_eval_vae_matches_jax_under_the_replayed_key_stream(vae_type):
    """Both splits at valid_k 50, M=2: the regularized type reads a fresh
    mask_p each batch, drawn from JAX's k_maskp."""
    kw = dict(vae_type=vae_type, M=2, batch_size=8, seed=3, missing_rate=30,
              latent_dim=L, valid_k=50)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    jds, tds = _tiny(seed=5)
    jparams = jmiwae.init(jax.random.PRNGKey(7), jc, 6)
    tparams = tckpt.params_from_jax(jckpt._flatten(jparams), "cpu")
    want = jeval.eval_vae(jds, jc, params=jparams, save=False)
    kinds = []

    def noise(kind, rep, step, shape):
        kinds.append(kind)
        return JaxEvalKeys(jax.random.PRNGKey(jc.seed + 1), tc)(
            kind, rep, step, shape)

    got = teval.eval_vae(tds, tc, params=tparams, noise=noise, save=False,
                         device="cpu")
    assert list(got) == list(want) == ["train", "test"]
    for stage in want:
        assert list(got[stage]) == list(want[stage])
        for name, value in want[stage].items():
            np.testing.assert_allclose(got[stage][name], value, rtol=RTOL,
                                       err_msg=f"{stage} {name}")
    # 2 reps x (3 + 2) batches, and a perm a rep a split
    per_batch = 2 if tc.info.regularized else 1
    assert len(kinds) == 2 * 2 + 2 * 5 * per_batch
    assert ("mask_p" in kinds) == tc.info.regularized


@pytest.mark.parametrize("vae_type", ["reg_MIWAE1", "vanilla_MIWAE2",
                                      "reg_notMIWAE3", "vanilla_notMIWAE1"])
@pytest.mark.parametrize("stage", ["train", "test"])
def test_eval_miwae_paths_match_jax(vae_type, stage):
    kw = dict(vae_type=vae_type, missing_rate=30, alpha=0.5,
              p_missingness=10, reg_type="ml_reg")
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    got = tart.eval_miwae_paths(tc, stage, "root")
    assert got == jart.eval_miwae_paths(jc, stage, "root")
    assert got["rmse"].endswith("_50_missing_rate_test.pt")


@pytest.mark.parametrize("vae_type", ["vanilla_MIWAE1", "reg_MIWAE1"])
def test_saved_artifacts_match_jax(tmp_path, vae_type):
    """The rmse file of each split at JAX's eval_miwae_paths name, and the
    four metrics of each split in metrics.jsonl."""
    kw = dict(vae_type=vae_type, M=2, batch_size=8, missing_rate=30,
              latent_dim=L, valid_k=20)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    jds, tds = _tiny(seed=8)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jparams = jmiwae.init(jax.random.PRNGKey(7), jc, 6)
    tparams = tckpt.params_from_jax(jckpt._flatten(jparams), "cpu")
    jeval.eval_vae(jds, jc, params=jparams, experiments_root=jroot)
    teval.eval_vae(tds, tc, params=tparams, experiments_root=troot,
                   noise=JaxEvalKeys(jax.random.PRNGKey(jc.seed + 1), tc),
                   device="cpu")
    jfiles, tfiles = _tree(jroot), _tree(troot)
    assert sorted(tfiles) == sorted(jfiles)
    assert len(tfiles) == 3  # an rmse file a split and metrics.jsonl
    for stage in ("train", "test"):
        rel = tart.eval_miwae_paths(tc, stage, troot)["rmse"][
            len(troot) + 1:]
        got = torch.load(tfiles[rel], weights_only=False)
        want = torch.load(jfiles[rel], weights_only=False)
        assert got.dtype == want.dtype == torch.float64 and got.shape == ()
        np.testing.assert_allclose(got.item(), want.item(), rtol=RTOL)
    rel = [r for r in tfiles if r.endswith("metrics.jsonl")][0]
    recs = [[json.loads(line) for line in open(f[rel])]
            for f in (tfiles, jfiles)]
    assert len(recs[0]) == len(recs[1]) == 8
    for got, want in zip(*recs):
        assert {k: v for k, v in got.items() if k not in ("time", "value")} \
            == {k: v for k, v in want.items() if k not in ("time", "value")}
        np.testing.assert_allclose(got["value"], want["value"], rtol=RTOL)


def test_miwae_checkpoint_loads_across_both_packages(tmp_path):
    kw = dict(vae_type="reg_MIWAE1", epoch=1, batch_size=8, latent_dim=L,
              train_k=4)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    jds, tds = _tiny_datasets(12, 5, seed=2)
    troot, jroot = str(tmp_path / "port"), str(tmp_path / "jax")
    params, hist = ttrain.train(tds, tc, experiments_root=troot,
                                device="cpu")
    assert np.isfinite(hist).all()
    got = tckpt.flatten(params)
    assert sorted(got) == [f"{part}/layer{i}/{leaf}" for part in
                           ("decoder", "encoder") for i in range(3)
                           for leaf in ("b", "w")]
    assert tckpt.checkpoint_path(tc, troot) == jckpt.checkpoint_path(
        jc, troot)
    loaded = jckpt._flatten(jtrain.load_trained(jds, jc, troot))
    assert sorted(loaded) == sorted(got)
    for k, v in got.items():
        np.testing.assert_array_equal(loaded[k], v.numpy(), err_msg=k)
    jparams, _ = jtrain.train(jds, jc, experiments_root=jroot)
    back = tckpt.flatten(ttrain.load_trained(tds, tc, jroot, device="cpu"))
    want = jckpt._flatten(jparams)
    assert sorted(back) == sorted(want)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    # the reference's state_dict of the trained parameters maps back to
    # them bit for bit
    sd = tckpt.export_state_dict(params, tc, 5)
    again = tckpt.flatten(tckpt.convert_state_dict(sd, tc, 5))
    assert sorted(again) == sorted(got)
    for k, v in got.items():
        np.testing.assert_array_equal(again[k], v.numpy(), err_msg=k)


@pytest.mark.parametrize("vae_type", ["vanilla_MIWAE1", "reg_MIWAE1"])
def test_full_budget_script_reads_the_miwae_rows_and_runs(vae_type, capsys):
    """engine/parity_full_budget.py `--vae_type`: the JAX row with its
    train_k 10 and valid_k 50, and one seed of one epoch on the CPU that
    reports every field (the verdict at one epoch means nothing)."""
    from vae_posterior_consistency_tpu_torch.engine import parity_full_budget
    config = parity_full_budget.row_config(vae_type)
    assert (config["train_k"], config["valid_k"]) == (10, 50)
    row = parity_full_budget.jax_row(config)
    assert (row["vae_type"], row["epochs"], row["seeds"]) == (vae_type, 3000,
                                                              4)
    rc = parity_full_budget.main(["--vae_type", vae_type, "--epochs", "1",
                                  "--seeds", "1", "--device", "cpu"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["config"] == config and result["epochs"] == 1
    assert result["test_rmse"]["jax_mean"] == row["report"]["test"]["rmse"][
        "ours_mean"]
    assert rc == (0 if result["verdict"] == "PARITY OK" else 1)
    assert np.isfinite(result["seeds"][0]["test_rmse"])


def test_full_budget_script_runs_the_mnar_notmiwae_row_as_jax_ran_it(
        capsys, monkeypatch):
    """reg_notMIWAE1's JAX row is an MNAR run: the port's configuration and
    loader call are those of tools/parity_check.py:run_ours_mnar (called
    with the row's batch size and the :488-490 importance samples, caught
    at its train call), and the row is found although it records
    missing_rate 30 for a run at 50."""
    import tools.parity_check as parity_check
    from vae_posterior_consistency_tpu.data import loaders as jloaders
    from vae_posterior_consistency_tpu.engine import train as jtrain
    from vae_posterior_consistency_tpu_torch.engine import parity_full_budget

    class Caught(Exception):
        pass

    calls = []

    def loader(*args, **kw):
        calls.append((args, kw))
        return jload(*args, **kw)

    def train(ds, cfg, **kw):
        raise Caught(cfg)

    jload = jloaders.data_loader_mnar
    monkeypatch.setattr(jloaders, "data_loader_mnar", loader)
    monkeypatch.setattr(jtrain, "train", train)
    config = parity_full_budget.row_config("reg_notMIWAE1")
    row = parity_full_budget.jax_row(config)
    with pytest.raises(Caught) as caught:
        parity_check.run_ours_mnar("reg_notMIWAE1", row["data_type"], 1,
                                   row["batch_size"], 0, 10, 50)
    jax_cfg = caught.value.args[0]
    assert config == {k: getattr(jax_cfg, k) for k in config}
    assert calls == [(("Data", "reg_notMIWAE1", 50, config["batch_size"],
                       config["data_type"]), {})]
    assert (row["vae_type"], row["missing_rate"], row["epochs"],
            row["seeds"]) == ("reg_notMIWAE1", 30, 3000, 4)
    monkeypatch.undo()

    rc = parity_full_budget.main(["--vae_type", "reg_notMIWAE1", "--epochs",
                                  "1", "--seeds", "1", "--device", "cpu"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["config"] == config and result["epochs"] == 1
    assert result["test_rmse"]["jax_mean"] == row["report"]["test"]["rmse"][
        "ours_mean"] == 0.319674476981163
    assert rc == (0 if result["verdict"] == "PARITY OK" else 1)
    assert list(result["means"]) == ["test_rmse"]
    assert np.isfinite(result["seeds"][0]["test_rmse"])

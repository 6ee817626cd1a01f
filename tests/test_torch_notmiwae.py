"""The port's notMIWAE family (`models/notmiwae.py`, its layers and its
registry entry) against the JAX package: JAX-initialised parameters carried
over by `checkpoint.params_from_jax` and JAX-drawn noise give the same
losses, gradients and evaluation rows for both encoder/decoder variants
('changed', 'author'), the three reg variants ('v2', 'both_s',
'sampled_mask'), the three missing processes and `fixed_iwae_bound`; two
Adam steps reproduce the five notMIWAE goldens of tests/test_golden.py;
`train` under the replayed JAX key stream reproduces JAX `train`; `eval_vae`
under the replayed evaluation keys reproduces JAX `eval_vae` and its
rmse-only artifacts; checkpoints, with the missing process's top-level `W`
and `b` and its `logits_lin`, load across both packages.

The 'sampled_mask' variant draws the p branch's mask as u < sigmoid(logits)
from uniforms u; where a u lies within an ulp of its threshold the two
packages' sigmoids may round to opposite sides. Its tests use JAX keys whose
uniforms lie at least 1e-4 from every threshold, and check that they do.

Tolerances as tests/test_torch_miwae.py: values rtol 1e-5, gradients rtol
1e-5 with atol 1e-5 * max|leaf|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_evaluate import JaxEvalKeys, _tiny, _tree
from test_torch_miwae import ATOL, RTOL, _assert_grads, _batch, _leaves
from test_torch_train import (
    GOLDEN_RTOL,
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
from vae_posterior_consistency_tpu.models import notmiwae as jnot
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.engine import evaluate as teval
from vae_posterior_consistency_tpu_torch.engine import train as ttrain
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.models import layers as tlayers
from vae_posterior_consistency_tpu_torch.models import notmiwae as tnot

D, B, L = 12, 16, 4
#: tests/test_golden.py's notMIWAE pairs
GOLDEN = {
    "vanilla_notMIWAE1": ("vanilla_notMIWAE1", {}, [11.296661, 11.138895]),
    "vanilla_notMIWAE1_author": (
        "vanilla_notMIWAE1", {"not_miwae_type": "author"},
        [12.010184, 11.547853]),
    "reg_notMIWAE1_v2": ("reg_notMIWAE1", {}, [11.157572, 10.926561]),
    "reg_notMIWAE1_both_s": (
        "reg_notMIWAE1", {"reg_notmiwae_variant": "both_s"},
        [15.900917, 15.661293]),
    "reg_notMIWAE1_sampled_mask": (
        "reg_notMIWAE1", {"reg_notmiwae_variant": "sampled_mask"},
        [14.520390, 14.400662]),
}
#: the least distance of a 'sampled_mask' uniform from its threshold
THRESHOLD_GAP = 1e-4


def _t(a):
    return torch.tensor(np.asarray(a))


def _cfgs(vae_type, **kw):
    kw = dict(vae_type=vae_type, latent_dim=L, **kw)
    return jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)


def _random_missing_process(jparams, seed=9):
    """W and b away from their xavier draw, logits_lin scaled up, so each
    process's logits span both signs."""
    rng = np.random.default_rng(seed)
    jparams["W"] = (rng.normal(size=(1, 1, D))).astype(np.float32)
    jparams["b"] = (0.5 + 0.2 * rng.normal(size=(1, 1, D))).astype(
        np.float32)
    jparams["logits_lin"] = jax.tree_util.tree_map(
        lambda a: 3.0 * a, jparams["logits_lin"])
    return jparams


@pytest.mark.parametrize("variant", ["changed", "author"])
def test_notmiwae_layers_and_their_gradients_match_jax(variant):
    """The encoder (ELU or Tanh trunk; the author's log-std clipped to
    [-10, 10]) on [B, D] and the decoder (sigmoid mean and logvar clipped
    to [-10, 0], or a linear mean and log(softplus^2)) on z [B, K, L]; the
    heads are scaled so some outputs sit beyond the clips."""
    x, mask, _ = _batch(1)
    enc = jlayers.notmiwae_encoder_init(jax.random.PRNGKey(2), D, L)
    dec = jlayers.notmiwae_decoder_init(jax.random.PRNGKey(3), D, L)
    enc["q_logstd"] = jax.tree_util.tree_map(lambda a: 40.0 * a,
                                             enc["q_logstd"])
    dec["x_logvar"] = jax.tree_util.tree_map(lambda a: 20.0 * a,
                                             dec["x_logvar"])
    z = np.random.default_rng(4).normal(size=(B, 5, L)).astype(np.float32)
    rng = np.random.default_rng(5)
    cots = [rng.normal(size=(B, L)).astype(np.float32) for _ in range(2)]
    cots += [rng.normal(size=(B, 5, D)).astype(np.float32) for _ in range(2)]

    def jfwd(enc, dec, z):
        return (*jlayers.notmiwae_encoder_apply(enc, x, mask, variant),
                *jlayers.notmiwae_decoder_apply(dec, z, variant))

    want = jfwd(enc, dec, z)
    if variant == "author":
        assert np.abs(want[1]).max() == 10.0  # the clip is reached
    else:
        assert want[3].min() == -10.0 and want[3].max() == 0.0
    want_g = jax.grad(lambda e, d, zz: sum(
        jnp.sum(o * c) for o, c in zip(jfwd(e, d, zz), cots)),
        argnums=(0, 1, 2))(enc, dec, z)
    tenc, enc_leaves = _leaves(enc)
    tdec, dec_leaves = _leaves(dec)
    tz = _t(z).requires_grad_()
    got = (*tlayers.notmiwae_encoder_apply(tenc, _t(x), _t(mask), variant),
           *tlayers.notmiwae_decoder_apply(tdec, tz, variant))
    for g, w in zip(got, want):
        # a linear head sums 128 products: entries near zero carry the
        # rounding of the head's largest outputs
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max())
    sum(torch.sum(g * _t(c)) for g, c in zip(got, cots)).backward()
    _assert_grads(enc_leaves, want_g[0], "encoder")
    _assert_grads(dec_leaves, want_g[1], "decoder")
    np.testing.assert_allclose(tz.grad.numpy(), want_g[2], rtol=RTOL,
                               atol=RTOL * np.abs(want_g[2]).max())


@pytest.mark.parametrize("process", ["selfmasking", "selfmasking_known",
                                     "linear"])
def test_missingness_logits_and_their_gradients_match_jax(process):
    jc, tc = _cfgs("vanilla_notMIWAE1")
    jparams = _random_missing_process(jnot.init(jax.random.PRNGKey(1), jc,
                                                D))
    x_mixed = np.random.default_rng(2).uniform(0, 1, (B, 3, D)).astype(
        np.float32)
    cot = np.random.default_rng(3).normal(size=(B, 3, D)).astype(np.float32)
    want = jnot.missingness_logits(jparams, x_mixed, process)
    want_g = jax.grad(lambda p: jnp.sum(
        jnot.missingness_logits(p, x_mixed, process) * cot))(jparams)
    tparams, leaves = _leaves(jparams)
    got = tnot.missingness_logits(tparams, _t(x_mixed), process)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    assert (np.asarray(want) > 0).any() and (np.asarray(want) < 0).any()
    torch.sum(got * _t(cot)).backward()
    want_flat = jckpt._flatten(want_g)
    for k, v in leaves.items():
        if v.grad is None:  # leaves this process does not read
            assert not np.any(want_flat[k]), k
            continue
        np.testing.assert_allclose(v.grad.numpy(), want_flat[k], rtol=RTOL,
                                   atol=RTOL * np.abs(want_flat[k]).max(),
                                   err_msg=k)


def _eps(key, cfg, K, rows=B):
    """The noise JAX's notmiwae train_loss draws from `key`
    (notmiwae.py:142, 69-78): [B, K, L] from kq, and from kp for a
    regularized type's p branch."""
    shape = (2, rows, K, L) if cfg.info.regularized else (rows, K, L)
    return model_noise(key, cfg, "eps", shape)


def _check_threshold_gap(jparams, x, mask, key, jc, process):
    """The 'sampled_mask' uniforms of `key` against JAX's thresholds
    sigmoid(logits of the q branch's first sample), notmiwae.py:150-158."""
    kq, _kp, ks = jax.random.split(key, 3)
    out_q = jnot.forward(jparams, x, mask, kq, jc, jc.train_k)
    m = mask[:, None, :]
    x_mixed = out_q["x_mean"] * (1.0 - m) + x[:, None, :] * m
    p = jax.nn.sigmoid(jnot.missingness_logits(jparams, x_mixed,
                                               process)[:, 0, :])
    u = jax.random.uniform(ks, p.shape)
    assert float(jnp.min(jnp.abs(u - p))) > THRESHOLD_GAP
    return u


#: (vae_type, config fields, missing process)
LOSS_CASES = [
    ("vanilla_notMIWAE1", {}, "selfmasking_known"),
    ("vanilla_notMIWAE1", {"not_miwae_type": "author"}, "selfmasking_known"),
    ("vanilla_notMIWAE1", {}, "selfmasking"),
    ("vanilla_notMIWAE1", {}, "linear"),
    ("vanilla_notMIWAE1", {"fixed_iwae_bound": True}, "selfmasking_known"),
    ("reg_notMIWAE1", {}, "selfmasking_known"),
    ("reg_notMIWAE1", {"not_miwae_type": "author"}, "selfmasking_known"),
    ("reg_notMIWAE1", {"reg_notmiwae_variant": "both_s"},
     "selfmasking_known"),
    ("reg_notMIWAE1", {"reg_notmiwae_variant": "both_s"}, "selfmasking"),
    ("reg_notMIWAE1", {"reg_notmiwae_variant": "sampled_mask"},
     "selfmasking_known"),
    ("reg_notMIWAE1", {"reg_notmiwae_variant": "sampled_mask",
                       "alpha": 0.5}, "linear"),
    ("reg_notMIWAE1", {"fixed_iwae_bound": True}, "linear"),
]


@pytest.mark.parametrize("vae_type,fields,process", LOSS_CASES)
def test_train_loss_and_gradients_match_jax(vae_type, fields, process):
    K = 6
    jc, tc = _cfgs(vae_type, train_k=K, **fields)
    jparams = _random_missing_process(jnot.init(jax.random.PRNGKey(1), jc,
                                                D))
    tparams, leaves = _leaves(jparams)
    x, mask, mask_p = _batch(2)
    key = jax.random.PRNGKey(3)
    extra = {}
    if tc.reg_notmiwae_variant == "sampled_mask":
        extra["mask_s"] = _t(_check_threshold_gap(jparams, x, mask, key, jc,
                                                  process))
    (want, want_aux), want_g = jax.jit(jax.value_and_grad(
        lambda p: jnot.train_loss(p, x, mask, mask_p, key, 1.0, jc,
                                  missing_process=process),
        has_aux=True))(jparams)
    loss, aux = tnot.train_loss(tparams, _t(x), _t(mask), _t(mask_p),
                                _eps(key, tc, K), 1.0, tc,
                                missing_process=process, **extra)
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    assert sorted(aux) == sorted(want_aux)
    for k in want_aux:
        np.testing.assert_allclose(aux[k].item(), float(want_aux[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    loss.backward()
    want_flat = jckpt._flatten(want_g)
    assert sorted(want_flat) == sorted(leaves)
    for k, v in leaves.items():
        if v.grad is None:  # leaves the missing process does not read
            assert not np.any(want_flat[k]), k
            continue
        w = want_flat[k]
        np.testing.assert_allclose(v.grad.numpy(), w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max(), err_msg=k)


def test_sampled_mask_needs_its_uniforms():
    jc, tc = _cfgs("reg_notMIWAE1", train_k=2,
                   reg_notmiwae_variant="sampled_mask")
    tparams = tnot.init(torch.Generator().manual_seed(0), tc, D,
                        device="cpu")
    x, mask, mask_p = map(_t, _batch(4))
    with pytest.raises(ValueError, match="mask_s"):
        tnot.train_loss(tparams, x, mask, mask_p, torch.zeros(2, B, 2, L),
                        1.0, tc)
    assert get_model(tc).train_noise(tc, B, D) == {"eps": (2, B, 2, L),
                                                   "mask_s": (B, D)}
    v2 = tc.replace(reg_notmiwae_variant="v2")
    assert get_model(v2).train_noise(v2, B, D) == {"eps": (2, B, 2, L)}


@pytest.mark.parametrize("fields", [{}, {"not_miwae_type": "author"},
                                    {"fixed_iwae_bound": True}])
def test_eval_step_matches_jax(fields):
    """K = valid_k = 50 samples of the q branch; the imputation weighs the
    50 x_means by softmax(-l_w)."""
    K = 50
    jc, tc = _cfgs("reg_notMIWAE1", valid_k=K, **fields)
    jparams = jnot.init(jax.random.PRNGKey(4), jc, D)
    tparams = tckpt.params_from_jax(jckpt._flatten(jparams), "cpu")
    x, mask, mask_p = _batch(5, rows=9)
    key = jax.random.PRNGKey(6)
    want = jax.jit(lambda p: jnot.eval_step(p, x, mask, mask_p, key,
                                            jc))(jparams)
    # from kq of split(key) alone (notmiwae.py:191)
    eps = _t(jax.random.normal(jax.random.split(key)[0], (9, K, L)))
    with torch.no_grad():
        got = get_model(tc).eval_step(tparams, _t(x), _t(mask), _t(mask_p),
                                      eps, tc)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["x_imputed"].numpy(), want["x_imputed"],
                               rtol=0, atol=ATOL)
    for name in ("row_loss", "row_negl", "row_negl_imp"):
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert get_model(tc).eval_noise(tc, 9, D) == {"eps": (9, K, L)}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_port_reproduces_the_notmiwae_golden_two_steps(name):
    """tests/test_golden.py's two Adam steps: latent 4, obs_dim 6, batch 16,
    train_k 3, keys PRNGKey(20 + i). For 'sampled_mask' the first key's
    uniforms lie at least THRESHOLD_GAP from their thresholds (checked); a
    flipped cell at the second step would move its loss off the golden."""
    vae_type, fields, want = GOLDEN[name]
    jc = jcfg.RunConfig(vae_type=vae_type, latent_dim=4, train_k=3, **fields)
    tc = tcfg.RunConfig(vae_type=vae_type, latent_dim=4, train_k=3, **fields)
    obs_dim, rows = 6, 16
    model = get_model(tc)
    jparams = jnot.init(jax.random.PRNGKey(11), jc, obs_dim)
    params = tckpt.unflatten({k: _t(v).requires_grad_(True) for k, v in
                              jckpt._flatten(jparams).items()})
    x = jax.random.uniform(jax.random.PRNGKey(12), (rows, obs_dim))
    mask = (jax.random.uniform(jax.random.PRNGKey(13), (rows, obs_dim)) < 0.7
            ).astype(jnp.float32)
    mask_p = mask * (jax.random.uniform(jax.random.PRNGKey(14),
                                        (rows, obs_dim)) < 0.7
                     ).astype(jnp.float32)
    opt = ttrain.make_optimizer(params)
    losses = []
    for i in range(2):
        key = jax.random.PRNGKey(20 + i)
        if tc.reg_notmiwae_variant == "sampled_mask" and not i:
            _check_threshold_gap(jparams, x, mask, key, jc,
                                 "selfmasking_known")
        drawn = {kind: model_noise(key, tc, kind, shape) for kind, shape in
                 model.train_noise(tc, rows, obs_dim).items()}
        opt.zero_grad()
        loss, _ = model.train_loss(params, _t(x), _t(mask), _t(mask_p),
                                   drawn.pop("eps"), float(i + 1), tc,
                                   **drawn)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, want, rtol=GOLDEN_RTOL)
    assert losses[1] != losses[0]


@pytest.mark.parametrize("vae_type,fields", [
    ("vanilla_notMIWAE1", {}), ("reg_notMIWAE1", {}),
    ("reg_notMIWAE1", {"reg_notmiwae_variant": "both_s",
                       "not_miwae_type": "author"})])
def test_train_reproduces_jax_train_under_the_notmiwae_key_stream(vae_type,
                                                                  fields):
    train_against_jax(vae_type, latent_dim=4, train_k=5, **fields)


def test_eval_vae_and_its_artifacts_match_jax(tmp_path):
    """vanilla_notMIWAE1 on both splits at valid_k 50, M=2: the metrics,
    the rmse file of each split at JAX's eval_miwae_paths name and the four
    metrics of each split in metrics.jsonl."""
    kw = dict(vae_type="vanilla_notMIWAE1", M=2, batch_size=8, seed=3,
              missing_rate=30, latent_dim=L, valid_k=50)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    jds, tds = _tiny(seed=5)
    jparams = jnot.init(jax.random.PRNGKey(7), jc, 6)
    tparams = tckpt.params_from_jax(jckpt._flatten(jparams), "cpu")
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jeval.eval_vae(jds, jc, params=jparams, experiments_root=jroot)
    got = teval.eval_vae(tds, tc, params=tparams, experiments_root=troot,
                         noise=JaxEvalKeys(jax.random.PRNGKey(jc.seed + 1),
                                           tc), device="cpu")
    assert list(got) == list(want) == ["train", "test"]
    for stage in want:
        assert list(got[stage]) == list(want[stage])
        for name, value in want[stage].items():
            np.testing.assert_allclose(got[stage][name], value, rtol=RTOL,
                                       err_msg=f"{stage} {name}")
    jfiles, tfiles = _tree(jroot), _tree(troot)
    assert sorted(tfiles) == sorted(jfiles) and len(tfiles) == 3
    for stage in ("train", "test"):
        path = jart.eval_miwae_paths(jc, stage, "")["rmse"].lstrip("/")
        np.testing.assert_allclose(
            torch.load(tfiles[path], weights_only=False).item(),
            got[stage]["rmse"], rtol=0, atol=1e-12)


def test_notmiwae_checkpoint_loads_across_both_packages(tmp_path):
    kw = dict(vae_type="reg_notMIWAE1", epoch=1, batch_size=8, latent_dim=L,
              train_k=4)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    jds, tds = _tiny_datasets(12, 5, seed=2)
    troot, jroot = str(tmp_path / "port"), str(tmp_path / "jax")
    params, hist = ttrain.train(tds, tc, experiments_root=troot,
                                device="cpu")
    assert np.isfinite(hist).all()
    got = tckpt.flatten(params)
    assert {"W", "b", "logits_lin/w", "logits_lin/b"} <= set(got)
    assert got["W"].shape == got["b"].shape == (1, 1, 5)
    assert got["logits_lin/w"].shape == (5, 5)
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

"""The port's flow-posterior family (`models/flow_vae.py`, its layers, its
registry entry and its checkpoints) against the JAX package: JAX-initialised
parameters carried over by `checkpoint.params_from_jax` and JAX-drawn noise
give the same losses, gradients and evaluation rows; two Adam steps
reproduce the `vanilla_flow1` golden of tests/test_golden.py; `train` under
the replayed JAX key stream reproduces JAX `train`; `eval_vae` under the
replayed evaluation keys reproduces JAX `eval_vae`; and a flow checkpoint,
with and without ActNorm, loads across the two packages both ways.

Tolerances: the training forward takes its spline bins from its inputs
(no cdf search), so values agree to float32 rounding of sums over 500-wide
layers: rtol 1e-5; gradients rtol 1e-5 with atol 1e-5 * max|leaf| (entries
near zero carry the rounding of their sums' largest terms). A log q(z)
through the three spline layers, forward or inverse: atol 5e-6, as in
tests/test_torch_flow.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_evaluate import JaxEvalKeys, _tiny
from test_torch_train import GOLDEN_RTOL, _tiny_datasets, train_against_jax
from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu.engine import evaluate as jeval
from vae_posterior_consistency_tpu.engine import train as jtrain
from vae_posterior_consistency_tpu.models import flow_vae as jflow_vae
from vae_posterior_consistency_tpu.models import get_model as jget_model
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.engine import evaluate as teval
from vae_posterior_consistency_tpu_torch.engine import train as ttrain
from vae_posterior_consistency_tpu_torch.models import flow_vae as tflow_vae
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.models import layers as tlayers

RTOL = 1e-5
STACK_ATOL = 5e-6
#: tests/test_golden.py's pinned pair for vanilla_flow1
GOLDEN_FLOW = [633.704041, 636.735046]


def _t(a):
    return torch.tensor(np.asarray(a))


def _cfgs(vae_type, **kw):
    kw = dict(vae_type=vae_type, latent_dim=4, hid_dim=16, **kw)
    return jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)


def _batch(seed, B, D):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (B, D)).astype(np.float32)
    mask = (rng.random((B, D)) < 0.7).astype(np.float32)
    mask_p = mask * (rng.random((B, D)) < 0.7).astype(np.float32)
    return x, mask, mask_p


def _random_actnorm(jparams, L):
    """Non-identity ActNorm affines, so the layers do something."""
    rng = np.random.default_rng(5)
    jparams["actnorm"] = [
        {"log_scale": (0.1 * rng.normal(size=L)).astype(np.float32),
         "shift": (0.1 * rng.normal(size=L)).astype(np.float32)}
        for _ in range(3)]
    return jparams


def _train_noise(key, cfg, B):
    """The base noise JAX's flow train_loss draws from `key`
    (flow_vae.py:96, nn/flow.py:185): [B, L] from each of split(key)."""
    kq, kp = jax.random.split(key)
    L = cfg.latent_dim
    if not cfg.info.regularized:
        return _t(jax.random.normal(kq, (B, L)))
    return _t(jnp.stack([jax.random.normal(kq, (B, L)),
                         jax.random.normal(kp, (B, L))]))


@pytest.mark.parametrize("actnorm", [False, True], ids=["plain", "actnorm"])
@pytest.mark.parametrize("tails", ["clamp", "linear"])
@pytest.mark.parametrize("vae_type", ["vanilla_flow1", "reg_flow1"])
def test_train_loss_and_gradients_match_jax(vae_type, tails, actnorm):
    D, B = 6, 16
    jc, tc = _cfgs(vae_type, flow_tails=tails, flow_actnorm=actnorm)
    jparams = jflow_vae.init(jax.random.PRNGKey(1), jc, D)
    if actnorm:
        jparams = _random_actnorm(jparams, jc.latent_dim)
    tparams = tckpt.params_from_jax(jckpt._flatten(jparams), "cpu")
    leaves = tckpt.flatten(tparams)
    for v in leaves.values():
        v.requires_grad_(True)
    x, mask, mask_p = _batch(2, B, D)
    key = jax.random.PRNGKey(3)

    def jloss(p):
        return jflow_vae.train_loss(p, x, mask, mask_p, key, 1.0, jc)

    (want, want_aux), want_g = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jparams)
    model = get_model(tc)
    loss, aux = model.train_loss(tparams, _t(x), _t(mask), _t(mask_p),
                                 _train_noise(key, tc, B), 1.0, tc)
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    assert sorted(aux) == sorted(want_aux)
    for k in want_aux:
        np.testing.assert_allclose(aux[k].item(), float(want_aux[k]),
                                   rtol=RTOL, atol=1e-6, err_msg=k)
    loss.backward()
    want_flat = jckpt._flatten(want_g)
    assert sorted(want_flat) == sorted(leaves)
    for k, v in leaves.items():
        if k.startswith("decoder/logvar/"):
            # the dead head: JAX's gradient is zero, the port gives none
            assert v.grad is None and not np.any(want_flat[k]), k
            continue
        w = want_flat[k]
        np.testing.assert_allclose(v.grad.numpy(), w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("actnorm", [False, True], ids=["plain", "actnorm"])
@pytest.mark.parametrize("tails", ["clamp", "linear"])
def test_eval_step_and_sample_logprob_hook_match_jax(tails, actnorm):
    D, B = 6, 9
    jc, tc = _cfgs("reg_flow1", flow_tails=tails, flow_actnorm=actnorm)
    jparams = jflow_vae.init(jax.random.PRNGKey(4), jc, D)
    if actnorm:
        jparams = _random_actnorm(jparams, jc.latent_dim)
    tparams = tckpt.params_from_jax(jckpt._flatten(jparams), "cpu")
    x, mask, _ = _batch(5, B, D)
    key = jax.random.PRNGKey(6)
    eps = _t(jax.random.normal(key, (B, jc.latent_dim)))  # flow_forward's
    want = jax.jit(lambda p: jflow_vae.eval_step(p, x, mask, mask, key,
                                                 jc))(jparams)
    model = get_model(tc)
    got = model.eval_step(tparams, _t(x), _t(mask), _t(mask), eps, tc)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["x_imputed"].numpy(), want["x_imputed"],
                               rtol=0, atol=1e-6)
    for name in ("row_loss", "row_negl", "row_negl_imp"):
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=RTOL,
                                   err_msg=name)
    want_lp = jget_model(jc).encode_sample_logprob(jparams, x, mask, key, jc)
    got_lp = model.encode_sample_logprob(tparams, _t(x), _t(mask), eps, tc)
    np.testing.assert_allclose(got_lp.numpy(), want_lp, rtol=0,
                               atol=STACK_ATOL)
    # the encoder's log-prob of an external z, the AIS / AL hook
    z = np.random.default_rng(7).uniform(-0.9, 0.9, (B, jc.latent_dim)
                                         ).astype(np.float32)
    np.testing.assert_allclose(
        tflow_vae.encoder_log_prob(tparams, _t(z), _t(x), _t(mask),
                                   tc).numpy(),
        jflow_vae.encoder_log_prob(jparams, z, x, mask, jc), rtol=0,
        atol=STACK_ATOL)


def test_init_has_jax_leaves_and_the_actnorm_flag_is_checked():
    for actnorm in (False, True):
        kw = dict(vae_type="reg_flow1", flow_actnorm=actnorm)
        jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
        jflat = jckpt._flatten(jflow_vae.init(jax.random.PRNGKey(0), jc, 13))
        tparams = tflow_vae.init(torch.Generator().manual_seed(0), tc, 13,
                                 device="cpu")
        tflat = tckpt.flatten(tparams)
        assert sorted(tflat) == sorted(jflat)
        for k, v in tflat.items():
            assert tuple(v.shape) == jflat[k].shape, k
        # the records' widths: a 26-500-500-100 encoder, a 10-500x4 decoder
        assert tflat["encoder/layer0/w"].shape == (26, 500)
        assert tflat["encoder/layer2/w"].shape == (500, 100)
        assert tflat["decoder/trunk/layer3/w"].shape == (500, 500)
        if actnorm:
            assert len(tparams["actnorm"]) == 3
            assert "actnorm/2/shift" in tflat
        other = tc.replace(flow_actnorm=not actnorm)
        with pytest.raises(ValueError, match="flow_actnorm"):
            tflow_vae.encode(tparams, torch.zeros(2, 13), torch.ones(2, 13),
                             torch.zeros(2, 10), other)
    assert tlayers.FLOW_OBS_LOGVAR == -8.0


def test_port_reproduces_the_vanilla_flow_golden_two_steps():
    """tests/test_golden.py's vanilla_flow1 pair: latent 4, the default
    hid_dim 500, obs_dim 6, batch 16, Adam(1e-3), keys PRNGKey(20 + i)."""
    jc = jcfg.RunConfig(vae_type="vanilla_flow1", latent_dim=4, train_k=3)
    tc = tcfg.RunConfig(vae_type="vanilla_flow1", latent_dim=4)
    obs_dim, B = 6, 16
    params = tckpt.unflatten({
        k: _t(v).requires_grad_(True) for k, v in jckpt._flatten(
            jflow_vae.init(jax.random.PRNGKey(11), jc, obs_dim)).items()})
    x = jax.random.uniform(jax.random.PRNGKey(12), (B, obs_dim))
    mask = (jax.random.uniform(jax.random.PRNGKey(13), (B, obs_dim)) < 0.7
            ).astype(jnp.float32)
    mask_p = mask * (jax.random.uniform(jax.random.PRNGKey(14), (B, obs_dim))
                     < 0.7).astype(jnp.float32)
    x, mask, mask_p = map(_t, (x, mask, mask_p))
    opt = ttrain.make_optimizer(params)
    model = get_model(tc)
    losses = []
    for i in range(2):
        opt.zero_grad()
        loss, _ = model.train_loss(
            params, x, mask, mask_p,
            _train_noise(jax.random.PRNGKey(20 + i), tc, B), float(i + 1), tc)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, GOLDEN_FLOW, rtol=GOLDEN_RTOL)
    assert losses[1] != losses[0]


@pytest.mark.parametrize("vae_type,extra", [
    ("reg_flow1", {}), ("vanilla_flow1", {"flow_actnorm": True})])
def test_train_reproduces_jax_train_under_the_flow_key_stream(vae_type,
                                                              extra):
    params = train_against_jax(vae_type, latent_dim=4, hid_dim=16, **extra)
    assert ("actnorm" in params) == bool(extra)


def test_eval_vae_matches_jax_under_the_replayed_key_stream():
    kw = dict(vae_type="reg_flow1", M=2, batch_size=8, seed=3,
              missing_rate=30, latent_dim=4, hid_dim=16)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    jds, tds = _tiny(seed=5)
    jparams = jget_model(jc).init(jax.random.PRNGKey(7), jc, 6)
    tparams = tckpt.params_from_jax(jckpt._flatten(jparams), "cpu")
    want = jeval.eval_vae(jds, jc, params=jparams, save=False)
    got = teval.eval_vae(tds, tc, params=tparams,
                         noise=JaxEvalKeys(jax.random.PRNGKey(jc.seed + 1)),
                         save=False, device="cpu")
    assert list(got) == list(want) == ["train", "test"]
    for stage in want:
        assert list(got[stage]) == list(want[stage])
        for name, value in want[stage].items():
            np.testing.assert_allclose(got[stage][name], value, rtol=RTOL,
                                       err_msg=f"{stage} {name}")


@pytest.mark.parametrize("actnorm", [False, True], ids=["plain", "actnorm"])
def test_flow_checkpoint_loads_across_both_packages(tmp_path, actnorm):
    kw = dict(vae_type="reg_flow1", epoch=1, batch_size=8, latent_dim=4,
              hid_dim=16, flow_actnorm=actnorm)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    jds, tds = _tiny_datasets(12, 5, seed=2)
    # the port writes, JAX reads
    troot, jroot = str(tmp_path / "port"), str(tmp_path / "jax")
    params, _ = ttrain.train(tds, tc, experiments_root=troot, device="cpu")
    got = tckpt.flatten(params)
    loaded = jckpt._flatten(jtrain.load_trained(jds, jc, troot))
    assert sorted(loaded) == sorted(got)
    for k, v in got.items():
        np.testing.assert_array_equal(loaded[k], v.numpy(), err_msg=k)
    # JAX writes, the port reads
    jparams, _ = jtrain.train(jds, jc, experiments_root=jroot)
    back = ttrain.load_trained(tds, tc, jroot, device="cpu")
    assert isinstance(back.get("actnorm", []), list)
    want = jckpt._flatten(jparams)
    back = tckpt.flatten(back)
    assert sorted(back) == sorted(want)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    # and the port's own round trip
    again = tckpt.flatten(ttrain.load_trained(tds, tc, troot, device="cpu"))
    for k, v in got.items():
        torch.testing.assert_close(again[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("vae_type", ["reg_flow1", "vanilla_flow1"])
def test_full_budget_script_reads_the_flow_rows_and_runs(vae_type, capsys):
    """engine/parity_full_budget.py `--vae_type`: the matching JAX row of
    tools/parity_full_budget.jsonl, and one seed of one epoch on the CPU
    that reports every field (the verdict at one epoch means nothing)."""
    from vae_posterior_consistency_tpu_torch.engine import parity_full_budget
    config = dict(vae_type=vae_type, **parity_full_budget.CONFIG)
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

"""Mixed precision (`compute_dtype='bfloat16'`) in the port against the JAX
package: `nn/core.dense` and its gradients, the EDDI embed held in bf16,
every family's `train_loss` and `eval_step`, the registry's wrapping, which
calls narrow (training, evaluation, serving, AL's `completion`) and which
stay float32 (AL's `encode_stats`, the AIS bridge), a seed ensemble (the
vmap path) and a 15-epoch trajectory.

Tolerances (measured on the CPU, where both packages round to bf16 the
same operands): a bf16 product's sums run in float32 in another order, so
forwards agree to float32 rounding of the sums (rtol 1e-5). Each gradient
of a bf16 operand is rounded to bf16 in both packages, and where the two
float32 sums straddle a rounding boundary the results are one bf16 ulp
apart (2^-7 of the value at most). Deeper in a model, a layer input that
rounds to the other bf16 neighbour moves what follows by 2^-8 of that
input: a family's gradients were measured within 0.0056 of each leaf's
largest magnitude (held at 2^-6) and its evaluation outputs within 2e-4
of their largest magnitude (held at 2^-8), its losses within 2.2e-6
(held at rtol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_active_learning import JaxALKeys
from test_torch_active_learning import _data as _al_data
from test_torch_active_learning import _params as _al_params
from test_torch_evaluate import JaxEvalKeys
from test_torch_serve import _jax_noise
from test_torch_sweep import (
    HIST_RTOL,
    JaxEnsembleKeys,
    _jax_init,
    _seed_keys,
)
from test_torch_sweep import _cfgs as _ens_cfgs
from test_torch_sweep import _datasets as _ens_datasets
from test_torch_train import JaxKeyStream, _tiny_datasets, model_noise
from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.engine import active_learning as jal
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu.engine import serve as jserve
from vae_posterior_consistency_tpu.engine import train as jtrain
from vae_posterior_consistency_tpu.models import get_model as jget_model
from vae_posterior_consistency_tpu.models import layers as jlayers
from vae_posterior_consistency_tpu.nn import core as jcore
from vae_posterior_consistency_tpu.parallel import sweep as jsweep
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.engine import active_learning as tal
from vae_posterior_consistency_tpu_torch.engine import ais as tais
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.engine import serve as tserve
from vae_posterior_consistency_tpu_torch.engine import train as ttrain
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.models import layers as tlayers
from vae_posterior_consistency_tpu_torch.nn import core as tcore
from vae_posterior_consistency_tpu_torch.parallel import sweep as tsweep

BF16 = "bfloat16"
#: one bf16 ulp of a value v is at most 2^-7 |v|
ULP = 2.0 ** -7
LOSS_RTOL = 1e-5
GRAD_SCALE = 2.0 ** -6
EVAL_SCALE = 2.0 ** -8


def _t(a):
    return torch.tensor(np.asarray(a))


def _one_ulp(got, want):
    """Every element equal or one bf16 ulp apart, or 1e-6 apart: a float32
    sum of O(1) terms that cancels to near zero carries about 1e-7 of
    rounding whatever its value (measured: 6.0e-8 at 6.5e-6)."""
    got, want = np.asarray(got), np.asarray(want)
    bound = ULP * np.maximum(np.abs(got), np.abs(want)) + 1e-6
    assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()


# ---------------------------------------------------------------------------
# nn/core.dense, the embed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x_shape", [(64, 300), (2, 16, 300)])
def test_dense_and_its_gradients_match_jax(x_shape):
    """dot(bf16(x), bf16(W), preferred f32) + b: the forward to float32
    rounding of the sums (rtol 1e-5); dx and dW, each rounded to bf16,
    equal or one bf16 ulp apart; db (a float32 sum of up to 32 rows of
    O(1) cotangents) to rtol 1e-5 and atol 1e-5."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal((300, 200)) * 0.05).astype(np.float32)
    b = rng.standard_normal(200).astype(np.float32)
    g = rng.standard_normal((*x_shape[:-1], 200)).astype(np.float32)

    def jdense(p, x):
        with jcore.compute_dtype(BF16):
            return jcore.dense(p, x)

    want, vjp = jax.vjp(jdense, {"w": w, "b": b}, x)
    want_p, want_x = vjp(g)
    p = {"w": _t(w).requires_grad_(), "b": _t(b).requires_grad_()}
    xt = _t(x).requires_grad_()
    with tcore.compute_dtype(BF16):
        got = tcore.dense(p, xt)
    got.backward(_t(g))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    _one_ulp(xt.grad.numpy(), want_x)
    _one_ulp(p["w"].grad.numpy(), want_p["w"])
    np.testing.assert_allclose(p["b"].grad.numpy(), want_p["b"], rtol=1e-5,
                               atol=1e-5)
    # outside the context the same call is the float32 product
    f32 = tcore.dense(p, xt).detach().numpy()
    assert tcore.active_dtype() == "float32"
    np.testing.assert_allclose(f32, x @ w + b, rtol=1e-5, atol=1e-5)
    assert not np.array_equal(f32, got.detach().numpy())


def test_the_bf16_embed_is_jax_s_bit_for_bit_and_pools_in_float32():
    """B = 64 rows of D = 784 features, K = 20: relu(bf16(x) * bf16(A) +
    bf16(C)), each op rounded, equal to JAX's bits; pooled in float32 under
    two masks as JAX pools it (rtol 1e-6)."""
    jp = jlayers.pointnet_encoder_init(jax.random.PRNGKey(1), 784, 20, 20,
                                       trunk_widths=(16, 12))
    tp = tckpt.params_from_jax(jckpt._flatten(jp), "cpu")
    rng = np.random.default_rng(2)
    x = rng.uniform(0.0, 1.0, (64, 784)).astype(np.float32)
    masks = (rng.random((2, 64, 784)) < 0.7).astype(np.float32)
    with jcore.compute_dtype(BF16):
        want = jax.jit(jlayers._pointnet_embed)(jp, x)
        want_pool = jax.jit(jlayers._pointnet_pool_multi)(jp, x, masks)
    got = tlayers._pointnet_embed_bf16(tp, _t(x))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    with tcore.compute_dtype(BF16):
        pooled = tlayers._pointnet_pool_multi(tp, _t(x), _t(masks))
    assert pooled.dtype == torch.float32
    np.testing.assert_allclose(pooled.numpy(), want_pool, rtol=1e-6,
                               atol=1e-5)


def test_the_card_s_product_function_on_emulated_products(monkeypatch):
    """`_Bf16Product`, the card's form of `bf16_product`, with its cuBLAS
    product replaced by the plain one (torch has no CPU kernel for
    `mm(out_dtype=float32)`): the forward equals the plain version; the
    backward rounds g to bf16 before its products and each gradient after
    them (ROADMAP C.4.33), so its gradients lie within one bf16 ulp of g's
    rounding from the plain version's; its vmap rule over a batched x, a
    batched W and both gives the loop of unbatched calls."""
    calls = []

    def emulated(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return torch.matmul(a.float(), b.float())

    monkeypatch.setattr(tcore, "_bf16_mm", emulated)
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((9, 7)).astype(np.float32))
    w = _t(rng.standard_normal((7, 5)).astype(np.float32))
    a = x.to(torch.bfloat16).requires_grad_()
    b = w.to(torch.bfloat16).requires_grad_()
    out = tcore._Bf16Product.apply(a, b)
    torch.testing.assert_close(out, tcore.bf16_product(a, b), rtol=0, atol=0)
    g = _t(rng.standard_normal((9, 5)).astype(np.float32))
    out.backward(g)
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    gb = g.to(torch.bfloat16).float()
    want_a = (gb @ b.detach().float().T).to(torch.bfloat16)
    want_b = (a.detach().float().T @ gb).to(torch.bfloat16)
    assert torch.equal(a.grad, want_a) and torch.equal(b.grad, want_b)
    assert len(calls) == 3  # the forward and one product a gradient

    xs = _t(rng.standard_normal((3, 4, 9, 7)).astype(np.float32))
    ws = _t(rng.standard_normal((3, 7, 5)).astype(np.float32))
    cases = [((0, None), (xs, w)), ((None, 0), (x, ws)), ((0, 0), (xs, ws))]
    for in_dims, args in cases:
        args = [t.to(torch.bfloat16) for t in args]
        got = torch.func.vmap(tcore._Bf16Product.apply, in_dims)(*args)
        want = torch.stack([
            tcore.bf16_product(*[t[i] if d == 0 else t
                                 for t, d in zip(args, in_dims)])
            for i in range(3)])
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# every family under bf16, the registry
# ---------------------------------------------------------------------------

#: a case each for gauss, EDDI, the flow, MIWAE and notMIWAE at small widths
FAMILIES = {
    "reg_vae1": dict(vae_type="reg_vae1"),
    "reg_EDDI1": dict(vae_type="reg_EDDI1", K=8),
    "reg_flow1": dict(vae_type="reg_flow1", hid_dim=16, latent_dim=4),
    "reg_MIWAE1": dict(vae_type="reg_MIWAE1", train_k=3, valid_k=5,
                       latent_dim=4),
    "reg_notMIWAE1": dict(vae_type="reg_notMIWAE1", train_k=3, valid_k=5,
                          latent_dim=4),
}


def _family_run(kw, dtype, D=12, B=16):
    """JAX's and the port's train_loss, its gradients and eval_step from
    the same parameters, batch and (replayed) noise."""
    jc = jcfg.RunConfig(compute_dtype=dtype, **kw)
    tc = tcfg.RunConfig(compute_dtype=dtype, **kw)
    jm, tm = jget_model(jc), get_model(tc)
    jp = jm.init(jax.random.PRNGKey(1), jc, D)
    rng = np.random.default_rng(2)
    x = rng.uniform(0.0, 1.0, (B, D)).astype(np.float32)
    mask = (rng.random((B, D)) < 0.7).astype(np.float32)
    mask_p = mask * (rng.random((B, D)) < 0.7).astype(np.float32)
    key, ekey = jax.random.PRNGKey(3), jax.random.PRNGKey(6)
    (jloss, _), jgrad = jax.jit(jax.value_and_grad(
        lambda p: jm.train_loss(p, x, mask, mask_p, key, jnp.float32(1.0),
                                jc), has_aux=True))(jp)
    jout = jax.jit(lambda p: jm.eval_step(p, x, mask, mask_p, ekey, jc))(jp)
    tp = tckpt.params_from_jax(jckpt._flatten(jp), "cpu")
    leaves = tckpt.flatten(tp)
    for v in leaves.values():
        v.requires_grad_(True)
    drawn = {k: model_noise(key, tc, k, s)
             for k, s in tm.train_noise(tc, B, D).items()}
    eps = drawn.pop("eps")
    loss, _ = tm.train_loss(tp, _t(x), _t(mask), _t(mask_p), eps, 1.0, tc,
                            **drawn)
    loss.backward()
    with torch.no_grad():
        out = tm.eval_step(tp, _t(x), _t(mask), _t(mask_p),
                           JaxEvalKeys(None, tc).eps(
                               ekey, tm.eval_noise(tc, B, D)["eps"]), tc)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    return (float(jloss), jckpt._flatten(jgrad), jout, loss.item(), grads,
            out)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_family_trains_and_evaluates_as_jax_under_bf16(family):
    jloss, jgrad, jout, loss, grads, out = _family_run(FAMILIES[family], BF16)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    assert sorted(grads) == sorted(jgrad)
    for k, g in grads.items():
        w = np.asarray(jgrad[k])
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_SCALE * np.abs(w).max(),
                                   err_msg=k)
    assert sorted(out) == sorted(jout)
    for k, v in out.items():
        w = np.asarray(jout[k])
        np.testing.assert_allclose(v.numpy(), w, rtol=0,
                                   atol=EVAL_SCALE * np.abs(w).max(),
                                   err_msg=k)
    # the products did narrow: the float32 run's loss is another number
    f32_loss = _family_run(FAMILIES[family], "float32")[3]
    assert f32_loss != loss


def test_get_model_wraps_train_loss_and_eval_step_only():
    """Two get_model calls compare equal (the wrappers are memoised, as the
    JAX package's `_dtype_wrapped`); the other hooks are the float32 ones;
    any other spelling raises ValueError."""
    for vae_type in ("reg_vae1", "reg_EDDI1", "reg_flow1", "reg_MIWAE1",
                     "vanilla_notMIWAE1"):
        cfg = tcfg.RunConfig(vae_type=vae_type, compute_dtype=BF16)
        model, f32 = get_model(cfg), get_model(cfg.replace(
            compute_dtype="float32"))
        assert model == get_model(cfg)
        assert model.train_loss != f32.train_loss
        assert model.eval_step != f32.eval_step
        assert model.train_loss.__wrapped__ is f32.train_loss
        assert model.encode_stats is f32.encode_stats
        assert model.encode_sample_logprob is f32.encode_sample_logprob
    for spelling in ("bf16", "bfloat", "float16"):
        with pytest.raises(ValueError, match="compute_dtype"):
            get_model(tcfg.RunConfig(compute_dtype=spelling))


# ---------------------------------------------------------------------------
# which calls narrow: AL, serving, AIS
# ---------------------------------------------------------------------------


def test_an_al_episode_narrows_its_completions_and_not_its_rewards():
    """A vanilla_vae1 episode under bf16 against JAX's (the head scaled as
    in test_torch_active_learning): imputations within 2^-8 of their
    range, the same reveals, rewards within the float32 reward tolerance
    plus what the imputations' bf16 differences move them by. The port's
    rewards are the float32 rewards of its own bf16 completions, bit for
    bit: `encode_stats` did not narrow."""
    kw = dict(vae_type="vanilla_vae1", M=2, seed=3, missing_rate=30,
              compute_dtype=BF16)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    jparams, tparams = _al_params(jc, 30.0)
    x, mask = _al_data()
    key = jax.random.PRNGKey(5)
    want = jal.active_learning_func(None, x, mask, jc, Repeat=1,
                                    params=jparams, key=key, save=False)
    got = tal.active_learning_func(None, x, mask, tc, Repeat=1,
                                   params=tparams, noise=JaxALKeys(key, tc),
                                   save=False, device="cpu")
    want = {k: np.asarray(v) for k, v in want.items()}
    im, R = got["im"][0], got["R_hist"][0]
    np.testing.assert_allclose(got["im"].numpy(), want["im"], rtol=0,
                               atol=EVAL_SCALE)
    np.testing.assert_array_equal(got["action"].numpy(), want["action"])
    np.testing.assert_allclose(R.numpy(), want["R_hist"][0], rtol=1e-3,
                               atol=1e-4)
    f32 = get_model(tc.replace(compute_dtype="float32"))
    action = got["action"][0].long()
    xt, m = torch.from_numpy(x), torch.zeros_like(torch.from_numpy(x))
    for t in range(x.shape[1] - 1):
        with torch.no_grad():
            again = tal.rewards(f32, tparams, tc, xt, m, im[t])
        assert torch.equal(again, R[t]), t
        m = m + torch.nn.functional.one_hot(action[:, t], x.shape[1])
    # the completions did narrow
    with torch.no_grad():
        f32_im = tal._impute_samples(tc.replace(compute_dtype="float32"),
                                     tparams, xt, torch.zeros_like(xt),
                                     JaxALKeys(key, tc)("im", 0, 0, (
                                         2, *tal.eps_shape(tc, *x.shape))))
    assert not torch.equal(f32_im, im[0])


def test_serving_narrows_as_the_jax_server_does():
    """MNIST reg_EDDI1 widths at D = 20: the bf16 server against JAX's,
    fed its eps, imputations within 2^-8, row scores within 2^-8 of their
    largest."""
    kw = dict(vae_type="reg_EDDI1", data_type="mnist", seed=3,
              compute_dtype=BF16)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    jparams = jget_model(jc).init(jax.random.PRNGKey(0), jc, 20)
    tparams = tckpt.params_from_jax(jckpt._flatten(jparams), "cpu")
    jsrv = jserve.ImputationServer(jparams, jc, 20, buckets=(4, 16))
    tsrv = tserve.ImputationServer(tparams, tc, 20, buckets=(4, 16),
                                   device="cpu", noise=_jax_noise(tc))
    f32 = tserve.ImputationServer(tparams, tc.replace(
        compute_dtype="float32"), 20, buckets=(4, 16), device="cpu",
        noise=_jax_noise(tc))
    rng = np.random.default_rng(0)
    for n in (3, 9):
        x = rng.uniform(0, 1, (n, 20)).astype(np.float32)
        mask = (rng.random((n, 20)) < 0.7).astype(np.float32)
        f_t, s_t = tsrv.impute(x * mask, mask)
        f_j, s_j = jsrv.impute(x * mask, mask)
        np.testing.assert_allclose(f_t, f_j, rtol=0, atol=EVAL_SCALE)
        np.testing.assert_allclose(s_t, s_j, rtol=0,
                                   atol=EVAL_SCALE * np.abs(s_j).max())
        assert not np.array_equal(f32.impute(x * mask, mask)[1], s_t)


def test_ais_under_bf16_is_the_float32_ais_bit_for_bit():
    """The AIS bridge's log_lik is not a wrapped function, so a bf16 record
    anneals in float32: the same estimate and chains bit for bit."""
    from test_torch_evaluate import _tiny
    _, tds = _tiny(seed=5, D=6)
    kw = dict(vae_type="reg_vae1", latent_dim=4, seed=2)
    cfg = tcfg.RunConfig(**kw)
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg, 6,
                                 device="cpu")
    runs = [tais.eval_ais(tds, cfg.replace(compute_dtype=dt), params=params,
                          schedule=tais.linear_schedule(5), n_sample=3,
                          save=False, device="cpu")
            for dt in ("float32", BF16)]
    for stage in ("train", "test"):
        a, b = runs[0][stage], runs[1][stage]
        assert np.array_equal(np.asarray(a.logw), np.asarray(b.logw))
        assert torch.equal(torch.as_tensor(a.latents),
                           torch.as_tensor(b.latents))


# ---------------------------------------------------------------------------
# training: a seed ensemble (vmap) and a trajectory
# ---------------------------------------------------------------------------


def test_a_bf16_seed_ensemble_trains_as_jax_s():
    """Two seeds of reg_EDDI1 for 2 epochs of 3 steps through the vmapped
    step (`torch.func.vmap` of the wrapped train_loss): histories at the
    ensembles' rtol, every weight within the learning rate a step of
    JAX's (Adam divides a gradient by its own magnitude, so bf16's one-ulp
    gradient differences move a weight by at most lr a step)."""
    jc, tc = _ens_cfgs("reg_EDDI1", epoch=2, compute_dtype=BF16)
    jds, tds = _ens_datasets(20, 6)
    seeds = [0, 1]
    want_p, want_h = jsweep.train_seed_ensemble(jds, jc, seeds)
    got_p, got_h = tsweep.train_seed_ensemble(
        tds, tc, seeds, device="cpu",
        noise=JaxEnsembleKeys("seed", tc, 2, seeds),
        params=_jax_init(jc, 6, _seed_keys(seeds)))
    np.testing.assert_allclose(got_h, want_h, rtol=HIST_RTOL)
    got, want = tckpt.flatten(got_p), jckpt._flatten(want_p)
    for k in got:
        diff = np.abs(got[k].numpy() - np.asarray(want[k])).max()
        assert diff <= ttrain.LEARNING_RATE * 2 * 3, (k, diff)


def test_a_15_epoch_bf16_trajectory_tracks_jax_s_and_float32():
    """JAX's tests/test_models.py:316-347 configuration (reg_EDDI_mnist1
    widths on 96 rows of 20 features, batch 32, latent 4, K 6), 15 epochs
    through `train` under JAX's replayed key stream: the bf16 losses track
    JAX's bf16 trajectory (rtol 1e-3: rounding differences grow over 45
    steps) and the port's float32 one within JAX's own 5%."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (96, 20)).astype(np.float32)
    mask = (rng.random((96, 20)) < 0.7).astype(np.float32)
    jds, tds = _tiny_datasets(96, 20, seed=5)
    jds.train.x, jds.train.mask = jnp.asarray(x), jnp.asarray(mask)
    tds.train.x, tds.train.mask = torch.from_numpy(x), torch.from_numpy(mask)
    hist = {}
    for dt in ("float32", BF16):
        kw = dict(vae_type="reg_EDDI_mnist1", data_type="mnist",
                  reg_type="kl_reg", batch_size=32, latent_dim=4, K=6,
                  epoch=15, seed=1, compute_dtype=dt)
        jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
        k_init, k_run = jax.random.split(jax.random.PRNGKey(jc.seed))
        init = jget_model(jc).init(k_init, jc, 20)
        _, hist[dt] = ttrain.train(
            tds, tc, save=False, device="cpu",
            noise=JaxKeyStream(k_run, tc),
            params=tckpt.params_from_jax(jckpt._flatten(init), "cpu"))
        if dt == BF16:
            _, want = jtrain.train(jds, jc, save=False)
            np.testing.assert_allclose(hist[dt], want, rtol=1e-3)
    assert np.isfinite(hist[BF16]).all() and len(hist[BF16]) == 15
    assert hist[BF16][-1] < hist[BF16][0]
    np.testing.assert_allclose(hist[BF16], hist["float32"], rtol=0.05)
    assert not np.array_equal(hist[BF16], hist["float32"])

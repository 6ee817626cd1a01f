"""The port's gauss family, layers, NN core and math against the JAX
package: JAX-initialised parameters carried over by params_from_jax and
JAX-drawn noise give the same numbers."""

import jax
import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu.models import gauss as jgauss
from vae_posterior_consistency_tpu.models import layers as jlayers
from vae_posterior_consistency_tpu.nn import core as jcore
from vae_posterior_consistency_tpu.ops import math as jmath
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.engine.checkpoint import (
    flatten,
    params_from_jax,
)
from vae_posterior_consistency_tpu_torch.models import gauss as tgauss
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.models import layers as tlayers
from vae_posterior_consistency_tpu_torch.nn import core as tcore
from vae_posterior_consistency_tpu_torch.ops import math as tmath


def _t(a):
    return torch.tensor(np.asarray(a))


def _inputs(seed, B, D):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (B, D)).astype(np.float32)
    mask = (rng.random((B, D)) < 0.7).astype(np.float32)
    return x, mask


@pytest.mark.parametrize("vae_type,data_type", [
    ("reg_EDDI1", "mnist"),  # the served model's widths
    ("vanilla_EDDI1", "wine"),
    ("reg_vae1", "wine"),
    ("vanilla_vae1_mask_augm", "wine"),
])
def test_eval_step_matches_jax(vae_type, data_type):
    D, B = 20, 9
    kw = dict(vae_type=vae_type, data_type=data_type, K=10, latent_dim=10)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    jparams = jgauss.init(jax.random.PRNGKey(3), jc, D)
    tparams = params_from_jax(jckpt._flatten(jparams), "cpu")
    x, mask = _inputs(4, B, D)
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda p, x, m, k: jgauss.eval_step(p, x, m, m, k, jc))(
        jparams, x, mask, key)
    # JAX's forward draws eps = normal(key, mean.shape) in reparameterize
    eps = jax.random.normal(key, (B, jc.latent_dim))
    got = get_model(tc).eval_step(tparams, _t(x), _t(mask), _t(mask), _t(eps),
                                  tc)
    np.testing.assert_allclose(got["x_imputed"].numpy(), want["x_imputed"],
                               rtol=0, atol=1e-5)
    for name in ("row_loss", "row_negl", "row_negl_imp"):
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-5,
                                   atol=1e-4, err_msg=name)


def test_mnist_widths_match_jax():
    kw = dict(vae_type="reg_EDDI1", data_type="mnist")
    jparams = jgauss.init(jax.random.PRNGKey(0), jcfg.RunConfig(**kw), 784)
    tparams = tgauss.init(torch.Generator().manual_seed(0),
                          tcfg.RunConfig(**kw), 784, device="cpu")
    jflat = jckpt._flatten(jparams)
    tflat = flatten(tparams)
    assert sorted(tflat) == sorted(jflat)
    for k, v in tflat.items():
        assert tuple(v.shape) == jflat[k].shape, k
        assert v.dtype == torch.float32 and v.device.type == "cpu"


def test_pointnet_affine_and_encoder_match_jax():
    D, B = 30, 6
    jp = jlayers.pointnet_encoder_init(jax.random.PRNGKey(1), D, 5, 8,
                                       trunk_widths=(16, 12))
    tp = params_from_jax(jckpt._flatten(jp), "cpu")
    for a, b in zip(tlayers._pointnet_affine(tp), jlayers._pointnet_affine(jp)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6)
    x, mask = _inputs(2, B, D)
    got = tlayers.pointnet_encoder_apply(tp, _t(x), _t(mask))
    want = jlayers.pointnet_encoder_apply(jp, x, mask)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hidden_act,final_act", [
    ("relu", "identity"), ("relu", "sigmoid"), ("elu", "tanh"),
    ("tanh", "softplus")])
def test_mlp_apply_matches_jax(hidden_act, final_act):
    jp = jcore.mlp_init(jax.random.PRNGKey(7), [6, 11, 4])
    tp = params_from_jax(jckpt._flatten(jp), "cpu")
    x = np.random.default_rng(8).standard_normal((5, 6)).astype(np.float32)
    got = tcore.mlp_apply(tp, _t(x), hidden_act, final_act)
    want = jcore.mlp_apply(jp, x, hidden_act, final_act)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_initializers_follow_torch_bounds():
    g = torch.Generator().manual_seed(0)
    lin = tcore.torch_linear_init(g, 50, 7, device="cpu")
    assert lin["w"].shape == (50, 7) and lin["b"].shape == (7,)
    assert lin["w"].abs().max() <= 1 / np.sqrt(50)
    xav = tcore.xavier_uniform(g, (40, 10), device="cpu")
    assert xav.abs().max() <= np.sqrt(6 / 50)
    assert xav.std() > 0.5 * np.sqrt(6 / 50) / np.sqrt(3)


def test_math_matches_jax():
    rng = np.random.default_rng(9)
    x, mean, logvar, eps = (rng.standard_normal((4, 3)).astype(np.float32)
                            for _ in range(4))
    np.testing.assert_allclose(
        tmath.normal_logpdf(_t(x), _t(mean), _t(logvar)).numpy(),
        jmath.normal_logpdf(x, mean, logvar), rtol=1e-6, atol=1e-6)
    for dim in (None, -1):
        np.testing.assert_allclose(
            tmath.kl_diag_std(_t(mean), _t(logvar), dim=dim).numpy(),
            jmath.kl_diag_std(mean, logvar, axis=dim), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tmath.reparameterize(_t(mean), _t(logvar), eps=_t(eps)).numpy(),
        mean + eps * np.exp(0.5 * logvar), rtol=1e-6, atol=1e-6)
    assert tmath.FIXED_X_LOGVAR == jmath.FIXED_X_LOGVAR
    zero = np.zeros_like(x)
    np.testing.assert_array_equal(
        tmath.std_normal_logpdf(_t(x)).numpy(),
        tmath.normal_logpdf(_t(x), _t(zero), _t(zero)).numpy())
    np.testing.assert_allclose(tmath.std_normal_logpdf(_t(x)).numpy(),
                               jmath.normal_logpdf(x, zero, zero), rtol=1e-6,
                               atol=1e-6)


def test_reparameterize_takes_exactly_one_noise_source():
    m = torch.zeros(2, 3)
    g = torch.Generator().manual_seed(1)
    z = tmath.reparameterize(m, m, generator=g)
    assert z.shape == (2, 3)
    with pytest.raises(ValueError):
        tmath.reparameterize(m, m)
    with pytest.raises(ValueError):
        tmath.reparameterize(m, m, eps=m, generator=g)


def test_anneal_and_masked_re_match_jax():
    rng = np.random.default_rng(10)
    x, xm = (rng.uniform(0, 1, (3, 5)).astype(np.float32) for _ in range(2))
    m = (rng.random((3, 5)) < 0.5).astype(np.float32)
    np.testing.assert_allclose(
        tgauss._masked_re(_t(x), _t(xm), None, _t(m), dim=-1).numpy(),
        jgauss._masked_re(x, xm, None, m, axis=-1), rtol=1e-6)
    assert tgauss._anneal(1400.0, True) == float(jgauss._anneal(1400.0, True))
    assert tgauss._anneal(1400.0, False) == 1.0

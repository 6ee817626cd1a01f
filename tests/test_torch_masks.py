"""The port's training masks against the JAX package: given the uniforms JAX
drew, `train_masks` gives exactly JAX's masks; under a torch.Generator the
element rates hold."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.ops import masks as jmasks
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.ops import masks as tmasks


@pytest.mark.parametrize("vae_type,p_missingness", [
    ("reg_vae1", 30), ("reg_EDDI1", 10), ("reg_vae2", 50),
    ("vanilla_vae1", 30), ("vanilla_EDDI1", 30)])
def test_train_masks_given_jax_uniforms_equal_jax(vae_type, p_missingness):
    kw = dict(vae_type=vae_type, p_missingness=p_missingness)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    rng = np.random.default_rng(p_missingness)
    mask = (rng.random((33, 17)) < 0.6).astype(np.float32)
    key = jax.random.PRNGKey(p_missingness)
    want = jmasks.train_masks(jc.info, jc, key, mask)
    # sub_mask draws uniform(key, mask.shape) (ops/masks.py:28-29)
    u = np.array(jax.random.uniform(key, mask.shape))
    got = tmasks.train_masks(tc.info, tc, torch.from_numpy(mask),
                             uniforms=torch.from_numpy(u))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_threshold_edge_is_the_jax_rule():
    """u < 1 - rate/100 in float32: a draw exactly at the threshold is
    missing, one just below it observed."""
    # the threshold as the JAX package computes it (ops/masks.py:28-29)
    thresh = np.asarray(1.0 - jnp.asarray(30, jnp.float32) / 100.0)
    assert thresh.dtype == np.float32
    u = np.array([thresh, np.nextafter(thresh, np.float32(0)), 0.0, 0.9999],
                 np.float32)
    got = tmasks.mcar_mask(u.shape, 30, uniforms=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), [0.0, 1.0, 1.0, 0.0])


@pytest.mark.parametrize("rate", [10, 30, 50])
def test_element_rates_under_a_generator(rate):
    gen = torch.Generator().manual_seed(rate)
    mask = tmasks.mcar_mask((400, 250), rate, generator=gen, device="cpu")
    n = mask.numel()
    observed = mask.mean().item()
    # binomial standard error, 5 sigma
    assert abs(observed - (1 - rate / 100)) < 5 * np.sqrt(0.25 / n)
    base = torch.ones(400, 250)
    base[:, ::2] = 0.0
    sub = tmasks.sub_mask(base, rate, generator=gen)
    assert torch.all(sub <= base)
    kept = sub[:, 1::2].mean().item()
    assert abs(kept - (1 - rate / 100)) < 5 * np.sqrt(0.25 / (n / 2))


def test_noise_is_explicit_and_with_drop_waits():
    """Every mask waits for its uniforms: given or drawn from a generator,
    exactly one of the two; a `_with_drop` type's two uniforms a cell come
    as one [2, B, D] tensor."""
    mask = torch.ones(3, 4)
    with pytest.raises(ValueError, match="exactly one"):
        tmasks.sub_mask(mask, 30)
    with pytest.raises(ValueError, match="exactly one"):
        tmasks.sub_mask(mask, 30, uniforms=torch.rand(3, 4),
                        generator=torch.Generator())
    with pytest.raises(ValueError, match="shape"):
        tmasks.sub_mask(mask, 30, uniforms=torch.rand(4, 3))
    cfg = tcfg.RunConfig(vae_type="vanilla_vae2_with_drop")
    with pytest.raises(ValueError, match="exactly one"):
        tmasks.train_masks(cfg.info, cfg, mask)
    with pytest.raises(ValueError, match="shape"):
        tmasks.train_masks(cfg.info, cfg, mask, uniforms=torch.rand(3, 4))
    eff, mask_p = tmasks.train_masks(cfg.info, cfg, mask,
                                     uniforms=torch.rand(2, 3, 4))
    assert eff.shape == mask_p.shape == (3, 4) and torch.all(mask_p == 1.0)


@pytest.mark.parametrize("vae_type", ["vanilla_vae1_with_drop",
                                      "vanilla_EDDI2_with_drop",
                                      "vanilla_vae3_with_drop_mask_augm"])
def test_eddi_drop_mask_given_jax_uniforms_equals_jax(vae_type):
    """Bit for bit: JAX draws temp from uniform(k1) and the keep draw from
    uniform(k2), (k1, k2) = split(k_mask) (ops/masks.py:38-40); the port
    takes them as uniforms[0] and uniforms[1]. Ties included: draws at
    0.99 and beyond, and keep draws exactly at 1 - temp."""
    jc, tc = jcfg.RunConfig(vae_type=vae_type), tcfg.RunConfig(
        vae_type=vae_type)
    rng = np.random.default_rng(7)
    mask = (rng.random((40, 13)) < 0.7).astype(np.float32)
    key = jax.random.PRNGKey(21)
    k1, k2 = jax.random.split(key)
    u = np.stack([np.asarray(jax.random.uniform(k, mask.shape))
                  for k in (k1, k2)])
    want = jmasks.train_masks(jc.info, jc, key, mask)
    got = tmasks.train_masks(tc.info, tc, torch.from_numpy(mask),
                             uniforms=torch.from_numpy(u))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tmasks.eddi_drop_mask(mask.shape, uniforms=torch.from_numpy(u)
                              ).numpy(),
        np.asarray(jmasks.eddi_drop_mask(key, mask.shape)))
    # the ties, through JAX's arithmetic on the same uniforms
    temp = np.array([0.5, 0.99, 0.995, 0.25, 0.0], np.float32)
    keep = (np.float32(1.0) - np.minimum(temp, np.float32(0.99))).astype(
        np.float32)
    ut = np.stack([temp, keep])
    want = (jnp.asarray(keep) < 1.0 - jnp.minimum(jnp.asarray(temp), 0.99)
            ).astype(jnp.float32)
    got = tmasks.eddi_drop_mask(temp.shape, uniforms=torch.from_numpy(ut))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.any()  # a draw exactly at the keep probability drops


def test_drop_mask_rate_under_a_generator():
    """P(kept) = 1 - E[min(U, 0.99)] = 1 - (0.99**2 / 2 + 0.99 * 0.01)."""
    gen = torch.Generator().manual_seed(3)
    drop = tmasks.eddi_drop_mask((400, 250), generator=gen, device="cpu")
    n = drop.numel()
    want = 1 - (0.99 ** 2 / 2 + 0.99 * 0.01)
    assert abs(drop.mean().item() - want) < 5 * np.sqrt(0.25 / n)

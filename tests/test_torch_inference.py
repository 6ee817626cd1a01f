"""The port's mutual-information diagnostics and `nn/tensor_utils` against
the JAX package's: `mutual_information` and `mutual_information_kde` (its
sample drawn from JAX's key) for each Gaussian-posterior family, the flow's
refusal, and every helper of `nn/tensor_utils` on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu.engine import inference as jinf
from vae_posterior_consistency_tpu.models import get_model as jget_model
from vae_posterior_consistency_tpu.nn import tensor_utils as jtu
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.engine import inference as tinf
from vae_posterior_consistency_tpu_torch.nn import tensor_utils as ttu

#: MI against JAX's: sums of B*L KL cells (of order 1) and means of B
#: log-densities, each after 50- to 128-wide float32 layers summed in
#: another order
MI_ATOL = 1e-4
MI_RTOL = 1e-5
#: the KDE: logsumexps over N kernels of squared distances summed over d
KDE_RTOL = 1e-5
KDE_ATOL = 1e-5

GAUSSIAN = ["vanilla_vae1", "reg_vae1_mask_augm", "reg_EDDI1", "reg_MIWAE1",
            "vanilla_notMIWAE1"]


def _setup(vae_type, B=24, D=9, seed=0):
    kw = dict(vae_type=vae_type, seed=seed)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    jparams = jget_model(jc).init(jax.random.PRNGKey(seed + 1), jc, D)
    tparams = tckpt.params_from_jax(jckpt._flatten(jparams), "cpu")
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (B, D)).astype(np.float32)
    mask = (rng.random((B, D)) < 0.7).astype(np.float32)
    return jc, tc, jparams, tparams, x, mask


@pytest.mark.parametrize("vae_type", GAUSSIAN)
def test_mutual_information_matches_jax(vae_type):
    jc, tc, jparams, tparams, x, mask = _setup(vae_type)
    want = float(jinf.mutual_information(jparams, jnp.asarray(x),
                                         jnp.asarray(mask), jc))
    got = tinf.mutual_information(tparams, torch.from_numpy(x),
                                  torch.from_numpy(mask), tc)
    assert got.dim() == 0
    assert got.item() == pytest.approx(want, rel=MI_RTOL, abs=MI_ATOL)


@pytest.mark.parametrize("vae_type", GAUSSIAN)
def test_mutual_information_kde_matches_jax(vae_type):
    jc, tc, jparams, tparams, x, mask = _setup(vae_type)
    key = jax.random.PRNGKey(jc.seed + 6)
    want = float(jinf.mutual_information_kde(
        jparams, jnp.asarray(x), jnp.asarray(mask), jc, key=key))
    eps = torch.tensor(np.asarray(jax.random.normal(
        key, (x.shape[0], tc.latent_dim))))
    got = tinf.mutual_information_kde(tparams, torch.from_numpy(x),
                                      torch.from_numpy(mask), tc, eps=eps)
    assert got.item() == pytest.approx(want, rel=MI_RTOL, abs=MI_ATOL)
    # the default sample: a generator seeded with cfg.seed + 6, the same
    # draw on every call
    first = tinf.mutual_information_kde(tparams, torch.from_numpy(x),
                                        torch.from_numpy(mask), tc)
    again = tinf.mutual_information_kde(tparams, torch.from_numpy(x),
                                        torch.from_numpy(mask), tc)
    assert torch.equal(first, again) and torch.isfinite(first)


@pytest.mark.parametrize("fn", ["mutual_information",
                                "mutual_information_kde"])
def test_the_flow_has_no_gaussian_posterior(fn):
    jc, tc, jparams, tparams, x, mask = _setup("reg_flow1")
    with pytest.raises(NotImplementedError, match="Gaussian-posterior"):
        getattr(jinf, fn)(jparams, jnp.asarray(x), jnp.asarray(mask), jc)
    with pytest.raises(NotImplementedError, match="Gaussian-posterior"):
        getattr(tinf, fn)(tparams, torch.from_numpy(x),
                          torch.from_numpy(mask), tc)


@pytest.mark.parametrize("n,m,d,loo", [
    (16, 16, 8, False), (16, 16, 8, True), (40, 40, 3, False),
    (40, 40, 3, True), (12, 5, 10, False)])
def test_gaussian_kde_log_eval_matches_jax(n, m, d, loo):
    """Leave-one-out scores the fit samples themselves (n == m)."""
    rng = np.random.default_rng(n * d)
    samples = rng.normal(0.0, 1.0, (n, d)).astype(np.float32)
    samples[:, 0] *= 0.05  # a collapsed dimension: its own bandwidth
    query = samples if loo else rng.normal(0.0, 1.0, (m, d)).astype(
        np.float32)
    want = np.asarray(jtu.gaussian_kde_log_eval(
        jnp.asarray(samples), jnp.asarray(query), loo=loo))
    got = ttu.gaussian_kde_log_eval(torch.from_numpy(samples),
                                    torch.from_numpy(query), loo=loo)
    np.testing.assert_allclose(got.numpy(), want, rtol=KDE_RTOL,
                               atol=KDE_ATOL)


def test_gaussian_kde_loo_needs_aligned_rows():
    s = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="row-aligned"):
        ttu.gaussian_kde_log_eval(s, s[:3], loo=True)
    # a constant sample set: the bandwidth is floored, the value finite
    assert torch.isfinite(ttu.gaussian_kde_log_eval(s + 1.0, s + 1.0)).all()


def test_shape_helpers_match_jax():
    x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    pairs = [
        (jtu.sum_except_batch(jx), ttu.sum_except_batch(tx)),
        (jtu.sum_except_batch(jx, 2), ttu.sum_except_batch(tx, 2)),
        (jtu.split_leading_dim(jx.reshape(6, 4, 5), (2, 3)),
         ttu.split_leading_dim(tx.reshape(6, 4, 5), (2, 3))),
        (jtu.merge_leading_dims(jx), ttu.merge_leading_dims(tx)),
        (jtu.merge_leading_dims(jx, 3), ttu.merge_leading_dims(tx, 3)),
        (jtu.repeat_rows(jx, 3), ttu.repeat_rows(tx, 3)),
        (jtu.tile(jx[0, 0, 0], 3), ttu.tile(tx[0, 0, 0], 3)),
    ]
    for want, got in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        ttu.tile(tx[0, 0, 0], 0)


@pytest.mark.parametrize("features", [1, 6, 7])
def test_binary_masks_match_jax(features):
    for even in (True, False):
        np.testing.assert_array_equal(
            ttu.create_alternating_binary_mask(features, even).numpy(),
            np.asarray(jtu.create_alternating_binary_mask(features, even)))
    np.testing.assert_array_equal(
        ttu.create_mid_split_binary_mask(features).numpy(),
        np.asarray(jtu.create_mid_split_binary_mask(features)))
    # the random mask: JAX's rule (floor(features/2) ones at the first
    # positions of a permutation) on the port's permutation
    g = torch.Generator().manual_seed(features)
    got = ttu.create_random_binary_mask(g, features)
    perm = torch.randperm(features, generator=torch.Generator().manual_seed(
        features)).numpy()
    want = np.zeros(features, np.float32)
    want[perm[:features // 2]] = 1.0
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32 and got.sum() == features // 2


@pytest.mark.parametrize("size", [1, 5, 16])
def test_random_orthogonal_matches_jax_on_the_same_gaussian(size):
    got = ttu.random_orthogonal(torch.Generator().manual_seed(size), size)
    a = torch.randn(size, size, generator=torch.Generator().manual_seed(size))
    q, r = jnp.linalg.qr(jnp.asarray(a.numpy()))
    want = np.asarray(q * jnp.sign(jnp.diag(r))[None, :])
    # QR of the same matrix: the sign rule makes it unique; LAPACK and XLA
    # round its Householder steps apart
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose((got.T @ got).numpy(), np.eye(size),
                               atol=1e-5)


def test_searchsorted_matches_jax():
    rng = np.random.default_rng(3)
    bins = np.sort(rng.uniform(0.0, 1.0, (4, 6, 9)), axis=-1).astype(
        np.float32)
    bins[..., 0], bins[..., -1] = 0.0, 1.0
    inputs = rng.uniform(0.0, 1.0, (4, 6)).astype(np.float32)
    inputs[0, :3] = (0.0, 1.0, bins[0, 2, 4])  # the edges and a knot
    want = np.asarray(jtu.searchsorted(jnp.asarray(bins),
                                       jnp.asarray(inputs)))
    got = ttu.searchsorted(torch.from_numpy(bins), torch.from_numpy(inputs))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert bins[0, 0, -1] == 1.0  # the caller's bins are not touched


@pytest.mark.parametrize("value", [True, np.bool_(False), 0, 3, -2,
                                   np.int64(8), 2.0, "4", None, 1, 6, 64])
def test_predicates_match_jax(value):
    for name in ("is_bool", "is_int", "is_positive_int", "is_nonnegative_int",
                 "is_power_of_two"):
        try:
            want = getattr(jtu, name)(value)
        except TypeError:
            want = TypeError
        try:
            got = getattr(ttu, name)(value)
        except TypeError:
            got = TypeError
        assert got == want, (name, value)

"""The port's last helpers against the JAX package's on seeded numpy
inputs: `ops/math` (logsumexp, masked_rmse, check, minmax_normalize,
standardize) at rtol 1e-6 (and one float32 ulp at 1 absolute), `ops/masks.toy_mask` bit for bit on the
uniforms whose order is JAX's permutation, `nn/core.param_count`, and
`engine/evaluate.eval_miwae`, the reference's alias of eval_vae."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu.engine import evaluate as jevaluate
from vae_posterior_consistency_tpu.models import get_model as jget_model
from vae_posterior_consistency_tpu.nn import core as jcore
from vae_posterior_consistency_tpu.ops import masks as jmasks
from vae_posterior_consistency_tpu.ops import math as jmath
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.engine import evaluate as tevaluate
from vae_posterior_consistency_tpu_torch.nn import core as tcore
from vae_posterior_consistency_tpu_torch.ops import masks as tmasks
from vae_posterior_consistency_tpu_torch.ops import math as tmath


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((9, 6)) * 3 + 1).astype(np.float32)
    y = rng.standard_normal((9, 6)).astype(np.float32)
    hole = (rng.random((9, 6)) < 0.4).astype(np.float32)
    return x, y, hole


CALLS = {
    "logsumexp_dim0": (lambda m, x, y, h: m.logsumexp(x, 0),
                       lambda m, x, y, h: m.logsumexp(x, 0)),
    "logsumexp_dim1": (lambda m, x, y, h: m.logsumexp(x, axis=1),
                       lambda m, x, y, h: m.logsumexp(x, dim=1)),
    "masked_rmse": (lambda m, x, y, h: m.masked_rmse(x, y, h),
                    lambda m, x, y, h: m.masked_rmse(x, y, h)),
    "masked_rmse_no_holes": (lambda m, x, y, h: m.masked_rmse(x, y, 0 * h),
                             lambda m, x, y, h: m.masked_rmse(x, y, 0 * h)),
    "check": (lambda m, x, y, h: m.check(x, -1.0, 2.5),
              lambda m, x, y, h: m.check(x, -1.0, 2.5)),
    "check_scalar": (lambda m, x, y, h: m.check(0.5, 0.0, 0.5),
                     lambda m, x, y, h: m.check(0.5, 0.0, 0.5)),
    "minmax_normalize": (lambda m, x, y, h: m.minmax_normalize(x),
                         lambda m, x, y, h: m.minmax_normalize(x)),
    "minmax_normalize_rows": (lambda m, x, y, h: m.minmax_normalize(x, 1),
                              lambda m, x, y, h: m.minmax_normalize(x, 1)),
    "standardize": (lambda m, x, y, h: m.standardize(x),
                    lambda m, x, y, h: m.standardize(x)),
}


@pytest.mark.parametrize("name", list(CALLS))
def test_the_math_helpers_match_jax(name):
    jfn, tfn = CALLS[name]
    x, y, hole = _inputs(len(name))
    want = np.asarray(jfn(jmath, jnp.asarray(x), jnp.asarray(y),
                          jnp.asarray(hole)))
    got = tfn(tmath, torch.from_numpy(x), torch.from_numpy(y),
              torch.from_numpy(hole))
    assert tuple(got.shape) == want.shape
    if want.dtype == bool:
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        # atol: one float32 ulp at 1, for an element near 0 after a
        # difference with a column mean, whose sum runs in another order
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=2.0 ** -23)


@pytest.mark.parametrize("B,rate", [(8, 30), (13, 50), (5, 0), (7, 100)])
def test_toy_mask_matches_jax_on_the_same_order(B, rate):
    """JAX observes column 1 on the first ceil(B(1 - rate)) rows of a
    permutation; the port on the rows of smallest uniform. Uniforms ranked
    as the permutation give the same mask."""
    key = jax.random.PRNGKey(B + rate)
    want = np.asarray(jmasks.toy_mask(key, B, rate))
    perm = np.asarray(jax.random.permutation(key, B))
    u = np.empty(B, np.float32)
    u[perm] = (np.arange(B) + 0.5) / B
    got = tmasks.toy_mask(B, rate, uniforms=torch.from_numpy(u),
                          device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = tmasks.toy_mask(B, rate,
                            generator=torch.Generator().manual_seed(0),
                            device="cpu")
    assert drawn[:, 1].sum() == want[:, 1].sum() and (drawn[:, 0] == 1).all()


@pytest.mark.parametrize("vae_type,kw", [
    ("reg_EDDI1", {}), ("reg_flow1", dict(flow_actnorm=True, hid_dim=16)),
    ("reg_notMIWAE1", {})])
def test_param_count_and_the_eval_miwae_alias(vae_type, kw):
    jc = jcfg.RunConfig(vae_type=vae_type, **kw)
    jparams = jget_model(jc).init(jax.random.PRNGKey(0), jc, 9)
    tparams = tckpt.params_from_jax(jckpt._flatten(jparams), "cpu")
    assert tcore.param_count(tparams) == jcore.param_count(jparams) > 0
    assert jevaluate.eval_miwae is jevaluate.eval_vae
    assert tevaluate.eval_miwae is tevaluate.eval_vae

"""The port's spline flow (`nn/flow.py`) against the JAX package's: the same
inputs, made from a seed with numpy, give the same outputs, log-dets and
gradients, for both tails, with ActNorm on and off, forward and inverse,
and at the ties (inputs on bin edges and at +-1).

Tolerances. The forward map takes its bin from the input alone, so one layer
agrees to float32 rounding: atol 1e-6. The inverse takes its bin and slope
from the cdf, a softmax and a cumulative sum whose bits differ between the
two frameworks (XLA's exp is not correctly rounded; about one exp in ten
differs from torch's by an ulp). A bin's two cdf entries, each off by up
to two ulps of 1, move its log-slope by up to 4 * 2**-24 / (the bin's
pdf): one inverse layer's log-det is held to that, over the smallest pdf
of the test's logits (`_inverse_logdet_atol`). Through three layers each
scales the rounding of the one before by its slope: 5e-6 at the logit
scale used here. At a tie the bin must not depend on those bits, so the
edge cases use uniform logits over 8 bins, whose pdf and cdf are exact in
both. Gradients: rtol 1e-5 with atol 1e-5 * max|gradient| (entries near
zero carry the rounding of the largest terms of their sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu.nn import flow as jflow
from vae_posterior_consistency_tpu_torch.nn import flow as tflow

ATOL = 1e-6
STACK_ATOL = 5e-6
GRAD_RTOL = 1e-5
#: bin logits ~ N(0, LOGIT_SCALE^2)
LOGIT_SCALE = 0.5


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol, err_msg=msg)


def _grad_close(got, want, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(want).max(),
                               err_msg=msg)


def _logits(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * LOGIT_SCALE).astype(np.float32)


def _inverse_logdet_atol(logits):
    pdf = np.asarray(jax.nn.softmax(logits, axis=-1))
    return ATOL + 4 * 2.0 ** -24 / pdf.min()


def _points(seed, shape, lo=-1.3, hi=1.3):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, shape).astype(np.float32)


def test_normalize_pdf_matches_jax_and_cuts_the_top_gradient():
    logits = _logits(0, (5, 3, 10))
    want_pdf, want_cdf = jflow._normalize_pdf(logits)
    lt = _t(logits, grad=True)
    pdf, cdf = tflow._normalize_pdf(lt)
    assert cdf.shape == (5, 3, 11)
    _close(pdf, want_pdf, ATOL)
    _close(cdf, want_cdf, ATOL)
    assert torch.all(cdf[..., 0] == 0.0) and torch.all(cdf[..., -1] == 1.0)
    w = np.random.default_rng(1).normal(size=(5, 3, 11)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jflow._normalize_pdf(a)[1] * w))(logits)
    (cdf * _t(w)).sum().backward()
    _grad_close(lt.grad, want)


def test_gather_bins_and_context_to_pdf_match_jax():
    rng = np.random.default_rng(2)
    table = rng.normal(size=(4, 6, 7)).astype(np.float32)
    idx = rng.integers(0, 7, size=(4, 6)).astype(np.int32)
    got = tflow._gather_bins(_t(table), torch.from_numpy(idx).long())
    np.testing.assert_array_equal(got.numpy(),
                                  jflow._gather_bins(table, idx))
    ctx = rng.normal(size=(3, 12)).astype(np.float32)
    np.testing.assert_array_equal(
        tflow.context_to_pdf(_t(ctx), 3, 4).numpy(),
        jflow.context_to_pdf(ctx, 3, 4))


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("tails", ["clamp", "linear"])
def test_spline_layer_matches_jax_with_gradients(inverse, tails):
    logits = _logits(3, (16, 10, 10))
    x = _points(4, (16, 10))
    fn = jflow.unconstrained_linear_spline
    want_y, want_ld = jax.jit(lambda a, b: fn(a, b, inverse=inverse,
                                              tails=tails))(x, logits)
    xt, lt = _t(x, grad=True), _t(logits, grad=True)
    y, ld = tflow.unconstrained_linear_spline(xt, lt, inverse=inverse,
                                              tails=tails)
    _close(y, want_y, ATOL, "outputs")
    _close(ld, want_ld, _inverse_logdet_atol(logits) if inverse else ATOL,
           "logdets")
    w = np.random.default_rng(5).normal(size=(16, 10)).astype(np.float32)

    def objective(x, logits):
        y, ld = fn(x, logits, inverse=inverse, tails=tails)
        return jnp.sum(y * w) + jnp.sum(ld)

    gx, gl = jax.jit(jax.grad(objective, argnums=(0, 1)))(x, logits)
    (torch.sum(y * _t(w)) + ld.sum()).backward()
    _grad_close(xt.grad, gx, "d inputs")
    _grad_close(lt.grad, gl, "d logits")


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_ties_on_bin_edges_and_at_the_bounds(inverse):
    """Uniform logits over 8 bins: pdf 1/8 and the cdf k/8, exact in both
    frameworks. Inputs on every bin edge, at +-1 and just outside; at +-1
    the forward output is clipped exactly at its bound, where the clip's
    gradient is 0.5 (jnp.clip), not torch.clamp's 1."""
    nb = 8
    edges = np.arange(nb + 1, dtype=np.float32) * np.float32(2.0 / nb) - 1
    x = np.concatenate([edges, [-1.0, 1.0, -1.001, 1.001]]
                       ).astype(np.float32)[:, None].repeat(3, 1)
    logits = np.zeros((x.shape[0], 3, nb), np.float32)
    fwd = jflow.linear_spline_inverse if inverse else \
        jflow.linear_spline_forward
    want_y, want_ld = jax.jit(fwd)(x, logits)
    xt, lt = _t(x, grad=True), _t(logits, grad=True)
    tfwd = tflow.linear_spline_inverse if inverse else \
        tflow.linear_spline_forward
    y, ld = tfwd(xt, lt)
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    _close(ld, want_ld, ATOL)
    gx, gl = jax.jit(jax.grad(lambda a, b: jnp.sum(fwd(a, b)[0]) + jnp.sum(
        fwd(a, b)[1]), argnums=(0, 1)))(x, logits)
    (y.sum() + ld.sum()).backward()
    np.testing.assert_array_equal(xt.grad.numpy(), gx)
    _grad_close(lt.grad, gl)
    if not inverse:
        # slope 1 inside; at +-1 the output sits exactly on the clip's
        # bound, which passes half the gradient; just outside, none
        np.testing.assert_array_equal(
            xt.grad[:, 0].numpy(), [0.5] + [1.0] * (nb - 1) + [0.5] * 3
            + [0.0, 0.0])
    for tails in ("clamp", "linear"):
        want = jflow.unconstrained_linear_spline(x, logits, inverse=inverse,
                                                 tails=tails)
        got = tflow.unconstrained_linear_spline(_t(x), _t(logits),
                                                inverse=inverse, tails=tails)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def _actnorm(seed, dim, identity=False):
    rng = np.random.default_rng(seed)
    if identity:
        return [jflow.actnorm_init(dim) for _ in range(jflow.NUM_LAYERS)]
    return [{"log_scale": (0.1 * rng.normal(size=dim)).astype(np.float32),
             "shift": (0.1 * rng.normal(size=dim)).astype(np.float32)}
            for _ in range(jflow.NUM_LAYERS)]


@pytest.mark.parametrize("actnorm", [None, "identity", "random"])
@pytest.mark.parametrize("tails", ["clamp", "linear"])
def test_flow_forward_and_log_prob_match_jax_with_gradients(tails, actnorm):
    B, L = 16, 6
    ctx = _logits(6, (B, L * L))
    key = jax.random.PRNGKey(7)
    eps = np.asarray(jax.random.normal(key, (B, L)))  # flow_forward's draw
    z_ext = _points(8, (B, L))
    jact = (None if actnorm is None
            else _actnorm(9, L, identity=actnorm == "identity"))
    tact = (None if jact is None else
            [{k: _t(v, grad=True) for k, v in p.items()} for p in jact])
    w = np.random.default_rng(10).normal(size=(B, L)).astype(np.float32)

    def jax_all(ctx, z_ext, act):
        z, lp = jflow.flow_forward(key, ctx, L, tails=tails, actnorm=act)
        lp_ext = jflow.flow_log_prob(z_ext, ctx, L, tails=tails, actnorm=act)
        return z, lp, lp_ext

    want = jax.jit(jax_all)(ctx, z_ext, jact)
    ct, zt = _t(ctx, grad=True), _t(z_ext, grad=True)
    z, lp = tflow.flow_forward(_t(eps), ct, L, tails=tails, actnorm=tact)
    lp_ext = tflow.flow_log_prob(zt, ct, L, tails=tails, actnorm=tact)
    for name, g, v in zip(("z", "log q(z)", "log q(z_ext)"),
                          (z, lp, lp_ext), want):
        _close(g, v, STACK_ATOL, name)

    def objective(ctx, z_ext, act):
        z, lp, lp_ext = jax_all(ctx, z_ext, act)
        return jnp.sum(z * w) + jnp.sum(lp) + jnp.sum(lp_ext * w)

    argnums = (0, 1) if jact is None else (0, 1, 2)
    grads = jax.jit(jax.grad(objective, argnums=argnums))(ctx, z_ext, jact)
    (torch.sum(z * _t(w)) + lp.sum() + torch.sum(lp_ext * _t(w))).backward()
    _grad_close(ct.grad, grads[0], "d context")
    _grad_close(zt.grad, grads[1], "d z")
    if jact is not None:
        for i, p in enumerate(tact):
            for k, v in p.items():
                _grad_close(v.grad, grads[2][i][k], f"d actnorm/{i}/{k}")


def test_identity_actnorm_reproduces_the_plain_stack():
    B, L = 8, 5
    ctx, eps = _t(_logits(11, (B, L * L))), _t(_points(12, (B, L)))
    act = [tflow.actnorm_init(L, device="cpu")
           for _ in range(tflow.NUM_LAYERS)]
    for tails in ("clamp", "linear"):
        plain = tflow.flow_forward(eps, ctx, L, tails=tails)
        with_act = tflow.flow_forward(eps, ctx, L, tails=tails, actnorm=act)
        for a, b in zip(plain, with_act):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_combinators_match_jax():
    rng = np.random.default_rng(13)
    x = rng.normal(size=(6, 8)).astype(np.float32)
    logits = _logits(14, (6, 8, 8))
    p = _actnorm(15, 8)[0]
    tp = {k: _t(v) for k, v in p.items()}

    def jspline(x, c, inv):
        return jflow.unconstrained_linear_spline(x, logits, inverse=inv,
                                                 tails="linear")

    def tspline(x, c, inv):
        return tflow.unconstrained_linear_spline(x, _t(logits), inverse=inv,
                                                 tails="linear")

    jlayers = [jspline, lambda x, c, inv: jflow.actnorm_apply(p, x, c, inv),
               jflow.inverse_transform(jspline)]
    tlayers = [tspline, lambda x, c, inv: tflow.actnorm_apply(tp, x, c, inv),
               tflow.inverse_transform(tspline)]
    for inverse in (False, True):
        got = tflow.composite_apply(tlayers, _t(x), inverse=inverse)
        want = jflow.composite_apply(jlayers, x, inverse=inverse)
        for g, w in zip(got, want):
            _close(g, w, STACK_ATOL)
    for inverse in (False, True):
        got = tflow.actnorm_apply(tp, _t(x), inverse=inverse)
        want = jflow.actnorm_apply(p, x, inverse=inverse)
        for g, w in zip(got, want):
            _close(g, w, ATOL)

    def half(fn):
        return lambda x, c, inv: fn(x, c, inv)

    ms_j = [half(lambda x, c, inv: jflow.actnorm_apply(
        {k: v[:x.shape[-1]] for k, v in p.items()}, x, c, inv))] * 3
    ms_t = [half(lambda x, c, inv: tflow.actnorm_apply(
        {k: v[:x.shape[-1]] for k, v in tp.items()}, x, c, inv))] * 3
    got = tflow.multiscale_apply(ms_t, _t(x))
    want = jflow.multiscale_apply(ms_j, x)
    for g, w in zip(got, want):
        _close(g, w, ATOL)
    assert issubclass(tflow.InverseNotAvailable, Exception)
    assert issubclass(tflow.InputOutsideDomain, Exception)
    assert (tflow.NUM_LAYERS, tflow.TAIL_BOUND) == (jflow.NUM_LAYERS,
                                                    jflow.TAIL_BOUND)

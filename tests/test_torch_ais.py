"""The port's AIS and BDMC (engine/ais.py) and its `ais_eval` entry point
against the JAX package: the schedules exactly; the five bridges'
log-likelihoods and simulations; the chains one temperature at a time from
JAX's own states and whole, under JAX's replayed keys, for the gauss, flow,
notMIWAE and MIWAE bridges; BDMC's bounds; the artifacts of eval_ais and
eval_bdmc; and the closed-form log Z cases of tests/test_ais.py with the
port's own generator.

A chain's accept decision is exp(cur_H - prop_H) > u: where the two sides
lie within rounding, two packages may decide differently and the chains
part. Every comparison below first asserts that each decision's log-space
gap |log prob - log u| clears GAP, then compares.
"""

import contextlib
import json
import math
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.data import loaders as jloaders
from vae_posterior_consistency_tpu.engine import ais as jais
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu.models import get_model as jget_model
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.data import loaders as tloaders
from vae_posterior_consistency_tpu_torch.engine import ais as tais
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.experiment_main import ais_eval
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.ops.math import student_t_logpdf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = [json.loads(line) for line in
           open(os.path.join(REPO, "Data", "imputation_args.json"))
           if line.strip()]
#: a decision's log-space gap that float32 rounding cannot cross: the two
#: packages' Hamiltonians agree to about 1e-6 of their size (O(1-100)) here
GAP = 1e-3
#: chain state after one temperature from the same state and draws: z, eps
#: and accept counts after ten leapfrog steps through the decoder agree to a
#: few float32 ulps (measured: 2.4e-7 on |z| ~ 1); logw sums log p(x|z) of
#: size up to ~1e3 (the flow's obs_logvar = -8): rtol 1e-5 of it
Z_ATOL = 1e-5
LOGW_RTOL = 1e-5
LOGW_ATOL = 1e-5
#: the five bridges' log_lik and sample_x
BRIDGE_RTOL = 1e-5
BRIDGE_ATOL = 1e-6
#: the bridges of the chain comparisons: (vae_type, RunConfig extras)
FAMILIES = [("reg_vae1", {}), ("reg_flow1", {"hid_dim": 16}),
            ("vanilla_notMIWAE1", {}), ("reg_MIWAE1", {})]
L, D = 3, 6


def _t(a):
    return torch.tensor(np.asarray(a))


class JaxChainKeys:
    """A port AIS noise source replaying a JAX chain's keys: `_prep_chains`
    splits `key` into (k_init, k_scan), z0 ~ normal(k_init), one key a
    temperature from split(k_scan, T-1), each split into the momenta's and
    the uniforms' (engine/ais.py:237-242, 402-409). `rev` answers the
    reverse chain's kinds instead."""

    def __init__(self, key, T, rev=False):
        self.k_init, k_scan = jax.random.split(key)
        self.keys = jax.random.split(k_scan, T - 1)
        self.kinds = ("v_rev", "u_rev") if rev else ("v", "u")

    def __call__(self, kind, t, shape, df=None):
        if kind == "z0":
            return _t(jax.random.normal(self.k_init, shape))
        kv, ku = jax.random.split(self.keys[t])
        if kind == self.kinds[0]:
            return _t(jax.random.normal(kv, shape))
        assert kind == self.kinds[1], kind
        return _t(jax.random.uniform(ku, shape))


class JaxBdmcKeys:
    """JAX `bdmc`'s keys (engine/ais.py:329-349): split(key, 3) into the
    simulation's, the forward chains' and the reverse chains'; z_true and
    the observation noise from split(k_sim) (normals, or jax.random.t with
    the decoder's df)."""

    def __init__(self, key, T):
        k_sim, k_fwd, k_rev = jax.random.split(key, 3)
        self.kz, self.kx = jax.random.split(k_sim)
        self.fwd = JaxChainKeys(k_fwd, T)
        self.rev = JaxChainKeys(k_rev, T, rev=True)

    def __call__(self, kind, t, shape, df=None):
        if kind == "z_true":
            return _t(jax.random.normal(self.kz, shape))
        if kind == "x_sim":
            return _t(jax.random.normal(self.kx, shape) if df is None else
                      jax.random.t(self.kx, jnp.asarray(df.numpy()), shape))
        return (self.rev if kind.endswith("_rev") else self.fwd)(
            kind, t, shape)


@contextlib.contextmanager
def recorded_jax_scan():
    """JAX's `lax.scan` stepped from Python, its step jitted, each carry
    kept: JAX's own chain, state by state."""
    real, carries = jax.lax.scan, []

    def scan(f, init, xs, **kw):
        step, carry = jax.jit(f), init
        carries.append(init)
        for i in range(xs[0].shape[0]):
            carry, _ = step(carry, jax.tree_util.tree_map(lambda a: a[i], xs))
            carries.append(carry)
        return carry, None

    jax.lax.scan = scan
    try:
        yield carries
    finally:
        jax.lax.scan = real


@contextlib.contextmanager
def recorded_port_steps(monkeypatch):
    """Each `ais_step` of the port's chains, as (prob, u, accept)."""
    real, steps = tais.ais_step, []

    def step(ll_fn, state, t0, t1, v, u, leapfrog=10):
        out, prob = real(ll_fn, state, t0, t1, v, u, leapfrog)
        steps.append((prob, u, out.accept_hist - state.accept_hist))
        return out, prob

    monkeypatch.setattr(tais, "ais_step", step)
    yield steps


def _assert_gaps(probs, us):
    gap = (torch.log(probs) - torch.log(us)).abs()
    assert bool((gap > GAP).all()), f"a decision within {GAP}: {gap.min()}"


def _params(vae_type, extra, obs_dim=D):
    jc = jcfg.RunConfig(vae_type=vae_type, latent_dim=L, **extra)
    tc = tcfg.RunConfig(vae_type=vae_type, latent_dim=L, **extra)
    jp = jget_model(jc).init(jax.random.PRNGKey(0), jc, obs_dim)
    return jc, tc, jp, tckpt.params_from_jax(jckpt._flatten(jp), "cpu")


@pytest.mark.parametrize("T", [2, 5, 50, 500])
def test_schedules_equal_jax(T):
    for name in ("linear_schedule", "sigmoidial_schedule"):
        want = getattr(jais, name)(T)
        got = getattr(tais, name)(T)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tais.as_schedule(got, "cpu").numpy(),
                                      np.asarray(jnp.asarray(want,
                                                             jnp.float32)))
    cfg = tcfg.RunConfig(ais_schedule="linear", n_ais_dist=T)
    np.testing.assert_array_equal(tais.default_schedule(cfg),
                                  jais.default_schedule(jcfg.RunConfig(
                                      ais_schedule="linear", n_ais_dist=T)))


@pytest.mark.parametrize("vae_type,extra", [
    ("reg_vae1", {}), ("reg_flow1", {"hid_dim": 16}),
    ("vanilla_notMIWAE1", {"not_miwae_type": "changed"}),
    ("vanilla_notMIWAE1", {"not_miwae_type": "author"}),
    ("reg_MIWAE1", {})])
def test_bridges_log_lik_and_sample_x_match_jax(vae_type, extra):
    """Each bridge's log p(x|z) on 8 (z, x) pairs and its simulation from
    the same draw (the Student-t's from the port's own df), at
    BRIDGE_RTOL; the family and convention as JAX's."""
    jc, tc, jp, tp = _params(vae_type, extra)
    jb, tb = jais.bridge_for(jc), tais.bridge_for(tc)
    assert (tb.family, tb.convention) == (jb.family, jb.convention)
    rng = np.random.default_rng(4)
    z = rng.normal(size=(8, L)).astype(np.float32)
    x = rng.uniform(size=(8, D)).astype(np.float32)
    np.testing.assert_allclose(
        tb.log_lik(tp, torch.tensor(z), torch.tensor(x)).numpy(),
        jb.log_lik(jp, jnp.asarray(z), jnp.asarray(x)), rtol=BRIDGE_RTOL,
        atol=BRIDGE_ATOL)
    key = jax.random.PRNGKey(9)
    drawn = []

    def noise(kind, t, shape, df=None):
        assert kind == "x_sim" and (df is None) == (jb.family != "miwae")
        drawn.append(df)
        return _t(jax.random.normal(key, shape) if df is None else
                  jax.random.t(key, jnp.asarray(df.numpy()), shape))

    got = tb.sample_x(tp, torch.tensor(z), noise).numpy()
    want = np.asarray(jb.sample_x(jp, jnp.asarray(z), key))
    assert len(drawn) == 1 and got.shape == want.shape == (8, D)
    np.testing.assert_allclose(got, want, rtol=BRIDGE_RTOL, atol=BRIDGE_ATOL)


@pytest.mark.parametrize("vae_type,extra", FAMILIES)
def test_chains_match_jax_step_by_step_and_whole(monkeypatch, vae_type,
                                                 extra):
    """5 rows, 4 chains a row, linear T=10 under JAX's replayed keys.
    One temperature: from each of JAX's own chain states (its scan stepped
    from Python), the port's `ais_step` with the same draws lands on JAX's
    next state (z, eps, logw within Z_ATOL / LOGW_RTOL, the accept counts
    equal). Whole chains: the port's `ais_batch`, its every decision's gap
    asserted first, gives JAX's estimate and final chains, decision for
    decision."""
    jc, tc, jp, tp = _params(vae_type, extra)
    jb, tb = jais.bridge_for(jc), tais.bridge_for(tc)
    x = np.random.default_rng(2).uniform(size=(5, D)).astype(np.float32)
    T, n, key = 10, 4, jax.random.PRNGKey(7)
    sched = jais.linear_schedule(T)
    with recorded_jax_scan() as carries:
        want = jais.ais_batch(None, jnp.asarray(x), n, L, sched, key,
                              log_lik_fn=lambda z, xr: jb.log_lik(jp, z, xr))
    assert len(carries) == T
    x_rep = torch.tensor(x).repeat(n, 1)
    src, st = JaxChainKeys(key, T), tais.as_schedule(sched, "cpu")
    B = 5 * n
    for t in range(T - 1):
        z, eps, hist, logw, j = map(_t, carries[t])
        state = tais.AISState(z, eps, hist, logw, float(j))
        v, u = src("v", t, (B, L)), src("u", t, (B,))
        nxt, prob = tais.ais_step(lambda z: tb.log_lik(tp, z, x_rep), state,
                                  st[t], st[t + 1], v, u)
        _assert_gaps(prob, u)
        z1, eps1, hist1, logw1, j1 = map(_t, carries[t + 1])
        assert torch.equal(nxt.accept_hist, hist1), t
        assert nxt.j == float(j1)
        torch.testing.assert_close(nxt.z, z1, rtol=0, atol=Z_ATOL)
        torch.testing.assert_close(nxt.eps, eps1, rtol=1e-6, atol=0)
        torch.testing.assert_close(nxt.logw, logw1, rtol=LOGW_RTOL,
                                   atol=LOGW_ATOL)
    with recorded_port_steps(monkeypatch) as steps:
        got = tais.ais_batch(None, torch.tensor(x), n, L, sched,
                             JaxChainKeys(key, T),
                             log_lik_fn=lambda z, xr: tb.log_lik(tp, z, xr))
    assert len(steps) == T - 1
    for prob, u, _ in steps:
        _assert_gaps(prob, u)
    for t, (_, _, accepted) in enumerate(steps):
        np.testing.assert_array_equal(
            accepted.numpy(), np.asarray(carries[t + 1][2] - carries[t][2]))
    assert got.latents.shape == want.latents.shape == (5, n, L)
    assert got.latents.dtype == np.float32
    np.testing.assert_allclose(got.latents, want.latents, rtol=0,
                               atol=Z_ATOL)
    np.testing.assert_allclose(got.logw, want.logw, rtol=LOGW_RTOL,
                               atol=LOGW_ATOL)


@pytest.mark.parametrize("vae_type,extra", [("reg_vae1", {}),
                                            ("reg_MIWAE1", {})])
def test_bdmc_bounds_match_jax(monkeypatch, vae_type, extra):
    """`bdmc` on 3 simulated rows, 4 chains, linear T=8, under JAX's
    replayed keys (the Student-t simulation of MIWAE included): the same
    z_true and x_sim, and, every decision's gap asserted, the same lower
    and upper bounds."""
    jc, tc, jp, tp = _params(vae_type, extra)
    jb, tb = jais.bridge_for(jc), tais.bridge_for(tc)
    T, key = 8, jax.random.PRNGKey(5)
    sched = jais.linear_schedule(T)
    want = jais.bdmc(None, 3, 4, L, sched, key,
                     log_lik_fn=lambda z, x: jb.log_lik(jp, z, x),
                     sample_fn=lambda z, k: jb.sample_x(jp, z, k))
    with recorded_port_steps(monkeypatch) as steps:
        got = tais.bdmc(None, 3, 4, L, sched, JaxBdmcKeys(key, T),
                        log_lik_fn=lambda z, x: tb.log_lik(tp, z, x),
                        sample_fn=lambda z, src: tb.sample_x(tp, z, src))
    assert len(steps) == 2 * (T - 1)
    for prob, u, _ in steps:
        _assert_gaps(prob, u)
    np.testing.assert_array_equal(got.z_true, want.z_true)
    np.testing.assert_allclose(got.x_sim, want.x_sim, rtol=BRIDGE_RTOL,
                               atol=BRIDGE_ATOL)
    for name in ("lower", "upper", "gap"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=LOGW_RTOL, atol=LOGW_ATOL,
                                   err_msg=name)


def _tiny():
    rng = np.random.default_rng(6)
    x = {st: rng.uniform(size=(n, D)).astype(np.float32)
         for st, n in (("train", 6), ("test", 4))}
    m = {st: np.ones_like(v) for st, v in x.items()}
    jds = jloaders.Dataset(
        train=jloaders.Split(jnp.asarray(x["train"]),
                             jnp.asarray(m["train"]), "train"),
        test=jloaders.Split(jnp.asarray(x["test"]), jnp.asarray(m["test"]),
                            "test"), obs_dim=D)
    tds = tloaders.Dataset(
        train=tloaders.Split(torch.tensor(x["train"]),
                             torch.tensor(m["train"]), "train"),
        test=tloaders.Split(torch.tensor(x["test"]), torch.tensor(m["test"]),
                            "test"), obs_dim=D)
    return jds, tds


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".pt"):
                path = os.path.join(dirpath, f)
                out[os.path.relpath(path, root)] = torch.load(
                    path, weights_only=False)
    return out


@pytest.mark.parametrize("vae_type", ["reg_vae1", "reg_flow1"])
def test_eval_ais_and_eval_bdmc_artifacts_match_jax(tmp_path, monkeypatch,
                                                    capsys, vae_type):
    """eval_ais over both splits and eval_bdmc (3 rows) at 4 chains, linear
    T=6, under JAX's keys (PRNGKey(seed + 4) folded with each split's
    index; PRNGKey(seed + 5)): the same files at the same paths with the
    same shapes and dtypes and values, the same metric records; the flow's
    warning printed letter for letter."""
    extra = {"hid_dim": 16} if "flow" in vae_type else {}
    kw = dict(ais_schedule="linear", n_ais_dist=6, **extra)
    jc, tc, jp, tp = _params(vae_type, kw)
    jds, tds = _tiny()
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jais.eval_ais(jds, jc, params=jp, n_sample=4,
                         experiments_root=jroot)
    jais.eval_bdmc(jds, jc, params=jp, n_sample=4, n_batch=3,
                   experiments_root=jroot)
    jax_out = capsys.readouterr().out
    key = jax.random.PRNGKey(tc.seed + 4)
    with recorded_port_steps(monkeypatch) as steps:
        got = tais.eval_ais(
            tds, tc, params=tp, n_sample=4, experiments_root=troot,
            noise=lambda i: JaxChainKeys(jax.random.fold_in(key, i), 6),
            device="cpu")
        tais.eval_bdmc(tds, tc, params=tp, n_sample=4, n_batch=3,
                       experiments_root=troot, device="cpu",
                       noise=JaxBdmcKeys(jax.random.PRNGKey(tc.seed + 5), 6))
    assert capsys.readouterr().out == jax_out
    assert ("[ais] WARNING: flow-family" in jax_out) == ("flow" in vae_type)
    for prob, u, _ in steps:
        _assert_gaps(prob, u)
    assert sorted(got) == sorted(want) == ["test", "train"]
    jtree, ttree = _tree(jroot), _tree(troot)
    assert sorted(ttree) == sorted(jtree) and len(ttree) == 6
    for rel, want_t in jtree.items():
        got_t = ttree[rel]
        assert got_t.dtype == want_t.dtype and got_t.shape == want_t.shape, rel
        torch.testing.assert_close(got_t, want_t, rtol=LOGW_RTOL,
                                   atol=max(LOGW_ATOL, Z_ATOL))

    def records(root):
        path = os.path.join(root, tc.experiment_type, tc.data_type,
                            "metrics.jsonl")
        return [json.loads(line) for line in open(path)]

    jrec, trec = records(jroot), records(troot)
    assert [(r["metric"], r["stage"]) for r in trec] == [
        (r["metric"], r["stage"]) for r in jrec] == [
        ("ais_logw", "train"), ("ais_logw", "test"), ("bdmc_gap", "sim")]
    for a, b in zip(trec, jrec):
        assert set(a) == set(b)
        np.testing.assert_allclose(a["value"], b["value"], rtol=LOGW_RTOL,
                                   atol=LOGW_ATOL)


def test_ais_recovers_tractable_logz_with_the_port_generator():
    """tests/test_ais.py:22: x = A z + noise, log p(x) in closed form
    (constant-free densities); the port's own noise, 0.35 nats."""
    s = 0.5
    rng = np.random.default_rng(0)
    A = torch.tensor(rng.normal(size=(2, 3)), dtype=torch.float32)
    x = torch.tensor(rng.normal(size=(4, 3)) * 0.8, dtype=torch.float32)

    def decoder_fn(z):
        return z @ A, torch.full((z.shape[0], 3), 2.0 * np.log(s))

    res = tais.ais_batch(decoder_fn, x, 64, 2, tais.linear_schedule(150),
                         tais.GeneratorNoise(0, "cpu"))
    cov = A.numpy().T @ A.numpy() + s ** 2 * np.eye(3)
    _, logdet = np.linalg.slogdet(cov)
    quad = np.einsum("bi,ij,bj->b", x.numpy(), np.linalg.inv(cov), x.numpy())
    expected = float(np.mean(-0.5 * (quad + logdet)))
    assert abs(res.logw - expected) < 0.35, (res.logw, expected)
    assert res.latents.shape == (4, 64, 2)


def test_bdmc_sandwich_brackets_tractable_logz_with_the_port_generator():
    """tests/test_ais.py:57: the forward bound below and the reverse bound
    above the closed form of the simulated rows, within 0.25 each, gap
    below 1."""
    s = 0.5
    rng = np.random.default_rng(3)
    A = torch.tensor(rng.normal(size=(2, 3)), dtype=torch.float32)

    def decoder_fn(z):
        return z @ A, torch.full((z.shape[0], 3), 2.0 * np.log(s))

    res = tais.bdmc(decoder_fn, 4, 64, 2, tais.linear_schedule(150),
                    tais.GeneratorNoise(0, "cpu"))
    cov = A.numpy().T @ A.numpy() + s ** 2 * np.eye(3)
    _, logdet = np.linalg.slogdet(cov)
    quad = np.einsum("bi,ij,bj->b", res.x_sim, np.linalg.inv(cov), res.x_sim)
    expected = float(np.mean(-0.5 * (quad + logdet)))
    assert res.lower <= expected + 0.25, (res.lower, expected)
    assert res.upper >= expected - 0.25, (res.upper, expected)
    assert -0.5 <= res.gap < 1.0, res


def test_student_t_bridge_recovers_tractable_logz_with_the_port_generator():
    """tests/test_ais.py:119: the Student-t bridge (df 5) on a 1-D latent
    model against dense float64 integration, 0.35 nats: the 'exact'
    convention, constants included."""
    s, df = 0.5, 5.0
    rng = np.random.default_rng(5)
    a = rng.normal(size=(1, 2))
    A = torch.tensor(a, dtype=torch.float32)
    x = torch.tensor(rng.normal(size=(4, 2)) * 0.8, dtype=torch.float32)

    def log_lik_fn(z, x_rep):
        return student_t_logpdf(x_rep, z @ A, torch.tensor(s),
                                torch.tensor(df)).sum(-1)

    res = tais.ais_batch(None, x, 64, 1, tais.linear_schedule(150),
                         tais.GeneratorNoise(0, "cpu"), log_lik_fn=log_lik_fn)
    zg = np.linspace(-8.0, 8.0, 4001)[:, None]
    log_prior = -0.5 * zg[:, 0] ** 2 - 0.5 * np.log(2.0 * np.pi)
    y = (x.numpy()[None] - (zg @ a)[:, None, :]) / s
    log_t = (math.lgamma(0.5 * (df + 1.0)) - math.lgamma(0.5 * df)
             - 0.5 * np.log(df * np.pi) - np.log(s)
             - 0.5 * (df + 1.0) * np.log1p(y ** 2 / df))
    integrand = log_prior[:, None] + log_t.sum(-1)
    m = integrand.max(0)
    log_px = m + np.log(np.trapezoid(np.exp(integrand - m), zg[:, 0], axis=0))
    assert abs(res.logw - float(np.mean(log_px))) < 0.35


def test_student_t_draw_is_seeded_and_leaves_the_global_stream():
    """The default source's Student-t simulation: the same seed gives the
    same draws, and the global generator's state is as it was."""
    df = torch.full((200, 3), 4.0)
    before = torch.random.get_rng_state()
    a, b = tais.student_t(df, 11), tais.student_t(df, 11)
    assert torch.equal(torch.random.get_rng_state(), before)
    assert torch.equal(a, b) and not torch.equal(a, tais.student_t(df, 12))
    assert abs(float(a.std()) - math.sqrt(2.0)) < 0.25  # var df/(df-2)


def test_mesh_option_waits_for_slice_10():
    """Since slice 10 part 2 the chains run on a mesh: on a one-device
    mesh nothing is padded and `ais_batch` is the single-device one, bit
    for bit."""
    from torch_dist_worker import one_rank_mesh

    x = torch.rand((3, D), generator=torch.Generator().manual_seed(1))
    _, tc, _, tp = _params("reg_vae1", {})
    bridge = tais.bridge_for(tc)

    def run(mesh):
        return tais.ais_batch(
            None, x, 3, L, tais.linear_schedule(4),
            tais.GeneratorNoise(0, "cpu"), mesh=mesh,
            log_lik_fn=lambda z, xr: bridge.log_lik(tp, z, xr))

    plain = run(None)
    with one_rank_mesh() as mesh:
        meshed = run(mesh)
    assert plain.logw == meshed.logw
    np.testing.assert_array_equal(plain.latents, meshed.latents)


# ---------------------------------------------------------------------------
# the ais_eval entry point
# ---------------------------------------------------------------------------


def _record(number, **defaults):
    record = json.loads(json.dumps(RECORDS[number - 1]))
    for key, value in defaults.items():
        record.setdefault(key, {"type": type(value).__name__, "help": ""})
        record[key]["default"] = value
    return record


def test_record_selection_matches_jax(tmp_path):
    """tests/test_ais.py:333: the record is the one whose vae_type was
    asked for, resolved by a probe parse, whatever the spelling; record 0
    outside the grid."""
    import importlib

    jmod = importlib.import_module("experiment_main.ais_eval")
    for vt in ("vanilla_vae1", "reg_flow1", "reg_MIWAE1", "nope"):
        assert (ais_eval._record_for_vae_type(RECORDS, vt)
                is jmod._record_for_vae_type(RECORDS, vt))
    assert ais_eval._record_for_vae_type(RECORDS, "nope") is RECORDS[0]
    parser = tcfg.setup_parser(RECORDS[0], "ais_eval")
    for argv in (["-vae_type", "vanilla_vae1"], ["-vae_type=vanilla_vae1"],
                 ["-vae", "vanilla_vae1"]):
        rec = ais_eval._record_for_vae_type(RECORDS,
                                            parser.parse_args(argv).vae_type)
        assert rec["vae_type"]["default"] == "vanilla_vae1"
        assert rec["missing_rate"]["default"] == 30


def _workdir(tmp_path, records, trained):
    """Data/ with `records` and a copy of Data/wine, and each of `trained`
    (a RunConfig) saved at its checkpoint name from seeded parameters."""
    os.makedirs(tmp_path / "Data")
    shutil.copytree(os.path.join(REPO, "Data", "wine"),
                    tmp_path / "Data" / "wine")
    with open(tmp_path / "Data" / "imputation_args.json", "w") as fh:
        for rec in records:
            fh.write(json.dumps(rec) + "\n")
    for cfg in trained:
        params = get_model(cfg).init(torch.Generator().manual_seed(1), cfg,
                                     13, device="cpu")
        tckpt.save(params, tckpt.checkpoint_path(
            cfg, str(tmp_path / "experiments")))
    return tmp_path


def test_entry_point_prints_jax_lines_and_writes_jax_artifacts(
        tmp_path, monkeypatch, capsys):
    """A grid of records 1 (reg_MIWAE1) and 34 (reg_vae1, cut to linear
    T=5, 3 chains a row): `-vae_type reg_vae1 -bdmc true` picks record 34
    (its checkpoint name, missing_rate 30), prints JAX's lines, each value
    the saved artifact's, and writes the elbos/ and latents/ artifacts."""
    record = _record(34, n_ais_dist=5, n_ais_iwae=3)
    cfg = tcfg.RunConfig.from_jsonl_record(record)
    monkeypatch.chdir(_workdir(tmp_path, [RECORDS[0], record], [cfg]))
    assert ais_eval.main(["-device", "cpu", "-vae_type", "reg_vae1",
                          "-bdmc", "true"]) == 0
    lines = capsys.readouterr().out.splitlines()
    base = os.path.join("experiments", "reg_vae1", "wine", "elbos",
                        "30_missing", "3000_epochs")
    shown = [ln for ln in lines if ln.startswith("  [")]
    assert len(shown) == 3
    for stage, line in zip(("train", "test"), shown):
        value = torch.load(os.path.join(base, f"{stage}_ais.pt"),
                           weights_only=False)
        assert line == f"  [{stage}] AIS log p(x) = {value.item():.4f}"
        lat = torch.load(os.path.join(base.replace("elbos", "latents"),
                                      f"{stage}_ais_true_latents.pt"),
                         weights_only=False)
        assert lat.dtype == torch.float32 and lat.shape[1:] == (3, 10)
    lower, upper = (torch.load(os.path.join(base, f"bdmc_{b}.pt"),
                               weights_only=False).item()
                    for b in ("lower", "upper"))
    assert shown[2] == (f"  [bdmc] sandwich on simulated data: "
                        f"lower={lower:.4f} upper={upper:.4f} "
                        f"gap={upper - lower:.4f} (schedule=linear, T=5)")
    assert re.fullmatch(r"Device: cpu \(the CPU\)", lines[0])


@pytest.mark.parametrize("flags,slice_name", [
    (["-seeds", "2"], None),
    # 'auto' on one device resolves to no mesh and runs, as in JAX; a mesh
    # ('1,1') runs the chains on it since slice 10 part 2
    (["-mesh", "auto"], None), (["-mesh", "1,1"], None),
    (["-profile", "traces"], None),
    # (no flag) a record asking for compute_dtype 'bfloat16', refused until
    # the mixed-precision slice, runs: AIS's bridge does not narrow
    ([], None)])
def test_entry_point_refuses_unported_flags(tmp_path, monkeypatch, capsys,
                                            flags, slice_name):
    """Every case runs. (No flag) a record asking for compute_dtype
    'bfloat16' writes JAX's artifacts, its estimates bit for bit the
    float32 record's (the chains anneal in float32, as in JAX). -seeds
    above 1, -profile and -mesh: `-seeds 2` writes the `.seed1` estimate,
    `-profile traces` prints JAX's line and leaves a trace, `-mesh auto`
    prints no mesh line and `-mesh 1,1` JAX's."""
    assert slice_name is None
    extra = {} if flags else {"compute_dtype": "bfloat16"}
    record = _record(34, n_ais_dist=3, n_ais_iwae=2, **extra)
    cfg = tcfg.RunConfig.from_jsonl_record(record)
    monkeypatch.chdir(_workdir(tmp_path, [record], [cfg]))
    path = tckpt.checkpoint_path(cfg, "experiments")
    shutil.copy(path, path + ".seed1")
    assert ais_eval.main(["-device", "cpu", *flags]) == 0
    out = capsys.readouterr().out
    base = os.path.join("experiments", "reg_vae1", "wine", "elbos",
                        "30_missing", "3000_epochs")
    assert os.path.isfile(os.path.join(base, "test_ais.pt"))
    if not flags:
        assert cfg.compute_dtype == "bfloat16"
        names = [os.path.join(base, f"{stage}_ais.pt")
                 for stage in ("train", "test")]
        saved = [torch.load(p, weights_only=False) for p in names]
        with open(os.path.join("Data", "imputation_args.json"), "w") as fh:
            fh.write(json.dumps(_record(34, n_ais_dist=3, n_ais_iwae=2))
                     + "\n")
        assert ais_eval.main(["-device", "cpu"]) == 0
        for path, value in zip(names, saved):
            assert torch.equal(torch.load(path, weights_only=False), value)
        return
    seeds = flags[0] == "-seeds"
    assert os.path.isfile(os.path.join(base, "test_ais.pt.seed1")) == seeds
    if flags == ["-mesh", "auto"]:
        assert "mesh=" not in out and "[test] AIS log p(x) = " in out
    elif flags[0] == "-mesh":
        assert "mesh={'dp': 1, 'tp': 1}: AIS chains dp-sharded" in out
        assert "[test] AIS log p(x) = " in out
    elif not seeds:
        assert "[profile] tracing to traces" in out
        assert any(os.path.getsize(os.path.join("traces", f)) > 0
                   for f in os.listdir("traces"))

"""The port's active learning, AIS and serving over a mesh, and its
`dryrun_multichip`, against the JAX package's on a dp = 2 mesh of its
virtual CPU devices.

One spawn of 2 gloo ranks (`torch_dist_worker.spawn`) runs every job; the
parent records the draws of JAX's keys at the padded global shapes
(`JaxALKeys`, `JaxChainKeys`, `JaxBdmcKeys`, the server's) and the ranks
replay them. Every size forces padding: 17 test rows, 3 rows x 3 chains, a
1-row request. Tolerances: AL reveals exactly equal once every top-two gap
clears the reward tolerance, the rewards, imputations and curve at the
serial and ensemble episodes' own bounds against JAX; AIS log-weights rtol
1e-5 and latents atol 1e-5 once every real chain's accept decision clears
1e-3 in log space; served cells atol 1e-4 and row scores rtol 1e-4."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.data import loaders as jloaders
from vae_posterior_consistency_tpu.engine import active_learning as jal
from vae_posterior_consistency_tpu.engine import ais as jais
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu.engine import serve as jserve
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.engine import active_learning as tal
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt

import torch_dist_worker as worker
import test_torch_active_learning as serial_al
import test_torch_al_ensemble as ensemble_al
from test_torch_active_learning import EPISODES, JaxALKeys, _data, _params
from test_torch_ais import GAP, JaxBdmcKeys, JaxChainKeys
from test_torch_ais import _params as _ais_params
from test_torch_al_ensemble import _stacked
from test_torch_parallel import _jmesh
from test_torch_serve import _jax_noise

#: AL: the serial and ensemble episodes' own bounds against JAX
#: (tests/test_torch_active_learning.py, tests/test_torch_al_ensemble.py):
#: the reward tolerance (a function of the reward), the imputations'
#: atol, and the curve's (rtol, atol)
AL_TOLS = {
    "al": (serial_al._reward_tol, serial_al.IM_ATOL,
           (serial_al.CURVE_RTOL, 0.0)),
    "al_ensemble": (ensemble_al._tol, ensemble_al.IM_ATOL,
                    (ensemble_al.RTOL, ensemble_al.ATOL)),
}
#: AIS: the estimates and the chains' final positions
LOGW_RTOL, Z_ATOL = 1e-5, 1e-5
#: serving: the imputed cells and the row scores
CELL_ATOL, SCORE_RTOL = 1e-4, 1e-4
#: AIS sizes: L and D of test_torch_ais, 3 rows x 3 chains (9 chains, the
#: rows padded to 4 on dp = 2), 5 temperatures
L, D, T, N_SAMPLE, ROWS = 3, 6, 5, 3, 3


def _kw(tc):
    return {f: getattr(tc, f) for f in tc.__dataclass_fields__}


def _flat(params):
    return {k: v.numpy() for k, v in tckpt.flatten(params).items()}


def _record(src, requests):
    """{(kind, *args, shape): numpy draw} of the source `src`."""
    return {(kind, *args, tuple(shape)): src(kind, *args, shape).numpy()
            for kind, *args, shape in requests}


def _al_requests(tc, n, D_, repeat):
    """Every draw of `repeat` episodes over n rows, at their shapes."""
    shape = (tc.M, *tal.eps_shape(tc, n, D_))
    reqs = []
    for r in range(repeat):
        reqs.append(("init", r, 0, shape))
        for t in range(D_ - 1):
            reqs += [("im", r, t, shape), ("mse", r, t, shape)]
    return reqs


def _al_cases(root):
    """The serial episode of vanilla_vae1 and the 2-replica ensemble
    episode of reg_EDDI1, one repeat each, on 17 test rows (padded to
    18)."""
    x, mask = _data()
    jm = _jmesh(2, 1)
    key = jax.random.PRNGKey(5)
    cases = {}
    for name, vae_type in (("al", "vanilla_vae1"),
                           ("al_ensemble", "reg_EDDI1")):
        M, _, head_scale, extra = EPISODES[vae_type]
        repeat = 1
        kw = dict(vae_type=vae_type, M=M, seed=3, missing_rate=30, **extra)
        jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
        jroot, troot = str(root / f"jax_{name}"), str(root / f"port_{name}")
        if name == "al":
            jp, tp = _params(jc, head_scale)
            want = jal.active_learning_func(
                None, x, mask, jc, experiments_root=jroot, Repeat=repeat,
                params=jp, key=key, mesh=jm)
        else:
            jp, tp, _ = _stacked(jc, head_scale)
            jp = jax.tree_util.tree_map(lambda a: a[:2], jp)
            tp = tckpt.unflatten({k: v[:2] for k, v in
                                  tckpt.flatten(tp).items()})
            want = jal.active_learning_ensemble(
                x, mask, jc, jp, experiments_root=jroot, key=key, mesh=jm)
        draws = _record(JaxALKeys(key, tc),
                        _al_requests(tc, x.shape[0] + 1, x.shape[1], repeat))
        job = ("al", dict(cfg=_kw(tc), x=x, params=_flat(tp), draws=draws,
                          root=troot, ensemble=name == "al_ensemble",
                          repeat=repeat))
        cases[name] = (job, {k: np.asarray(v) for k, v in want.items()})
    return cases


def _ais_data():
    rng = np.random.default_rng(11)
    return (rng.uniform(size=(ROWS, D)).astype(np.float32),
            np.ones((ROWS, D), np.float32),
            rng.uniform(size=(2, D)).astype(np.float32),
            np.ones((2, D), np.float32))


def _chain_requests(B, kinds=("v", "u"), z0=True):
    reqs = [("z0", 0, (B, L))] if z0 else []
    for t in range(T - 1):
        reqs += [(kinds[0], t, (B, L)), (kinds[1], t, (B,))]
    return reqs


def _ais_cases(root):
    """ais_batch and bdmc on 3 rows (4 padded, 12 chains), eval_ais,
    eval_ais_ensemble (2 replicas) and eval_bdmc on a 3-row train and a
    2-row test split, JAX's on dp = 2 and the port jobs replaying its
    keys."""
    jc, tc, jp, tp = _ais_params("reg_vae1", {})
    jc, tc = jc.replace(seed=3), tc.replace(seed=3)
    jm = _jmesh(2, 1)
    sched = jais.linear_schedule(T)
    bridge = jais.bridge_for(jc)
    ll = functools.partial(bridge.log_lik, jp)
    data = _ais_data()
    jds = jloaders.Dataset(jloaders.Split(jnp.asarray(data[0]),
                                          jnp.asarray(data[1]), "train"),
                           jloaders.Split(jnp.asarray(data[2]),
                                          jnp.asarray(data[3]), "test"), D)
    B = 4 * N_SAMPLE  # the 3 rows padded to 4
    common = dict(cfg=_kw(tc), params=_flat(tp), n_sample=N_SAMPLE, T=T)
    cases = {}
    key = jax.random.PRNGKey(9)
    res = jais.ais_batch(None, jnp.asarray(data[0]), N_SAMPLE, L, sched, key,
                         mesh=jm, log_lik_fn=ll)
    cases["ais_batch"] = (("ais", dict(
        common, fn="ais_batch", data=data[0],
        draws=_record(JaxChainKeys(key, T), _chain_requests(B)))),
        {"logw": res.logw, "latents": res.latents})
    res = jais.bdmc(None, ROWS, N_SAMPLE, L, sched, key, mesh=jm,
                    log_lik_fn=ll,
                    sample_fn=functools.partial(bridge.sample_x, jp))
    bdmc_reqs = ([("z_true", 0, (ROWS, L)), ("x_sim", 0, (ROWS, D))]
                 + _chain_requests(B)
                 + _chain_requests(B, ("v_rev", "u_rev"), z0=False))
    cases["bdmc"] = (("ais", dict(
        common, fn="bdmc", n_batch=ROWS,
        draws=_record(JaxBdmcKeys(key, T), bdmc_reqs))),
        {"lower": res.lower, "upper": res.upper})
    # the splits' chains: 3 train rows padded to 4, 2 test rows not padded
    k_ais = jax.random.PRNGKey(tc.seed + 4)
    split_draws = [_record(JaxChainKeys(jax.random.fold_in(k_ais, i), T),
                           _chain_requests(b))
                   for i, b in enumerate((B, 2 * N_SAMPLE))]
    want = jais.eval_ais(jds, jc, params=jp, schedule=sched,
                         n_sample=N_SAMPLE, experiments_root=str(
                             root / "jax_eval_ais"), mesh=jm)
    cases["eval_ais"] = (("ais", dict(
        common, fn="eval_ais", data=data, draws=split_draws,
        root=str(root / "port_eval_ais"))),
        {st: {"logw": r.logw, "latents": r.latents}
         for st, r in want.items()})
    jp2 = jax.tree_util.tree_map(
        lambda a, b: jnp.stack([a, b]), jp,
        jax.tree_util.tree_map(lambda a: a * 0.9, jp))
    tp2 = tckpt.params_from_jax(jckpt._flatten(jp2), "cpu")
    want = jais.eval_ais_ensemble(jds, jc, jp2, schedule=sched,
                                  n_sample=N_SAMPLE, experiments_root=str(
                                      root / "jax_eval_ais_ensemble"),
                                  mesh=jm)
    cases["eval_ais_ensemble"] = (("ais", dict(
        common, fn="eval_ais_ensemble", params=_flat(tp2), data=data,
        draws=split_draws, root=str(root / "port_eval_ais_ensemble"))),
        {st: {"logw": r.logw, "latents": r.latents}
         for st, r in want.items()})
    want = jais.eval_bdmc(jds, jc, params=jp, schedule=sched,
                          n_sample=N_SAMPLE, experiments_root=str(
                              root / "jax_eval_bdmc"), mesh=jm)
    n_batch = 2  # min(batch_size, the test split's rows)
    reqs = ([("z_true", 0, (n_batch, L)), ("x_sim", 0, (n_batch, D))]
            + _chain_requests(n_batch * N_SAMPLE)
            + _chain_requests(n_batch * N_SAMPLE, ("v_rev", "u_rev"),
                              z0=False))
    cases["eval_bdmc"] = (("ais", dict(
        common, fn="eval_bdmc", data=data, root=str(root / "port_eval_bdmc"),
        draws=_record(JaxBdmcKeys(jax.random.PRNGKey(tc.seed + 5), T),
                      reqs))),
        {"lower": want.lower, "upper": want.upper})
    return cases


def _serve_case():
    """A 1-row request (bucket 1 rounds up to 2 on dp = 2) and a 5-row
    one (bucket 8), the JAX server on dp = 2 and the port's replaying its
    keys."""
    jc, tc, jp, tp = _ais_params("reg_vae1", {})
    jc, tc = jc.replace(seed=3), tc.replace(seed=3)
    rng = np.random.default_rng(2)
    requests = [(rng.uniform(size=(n, D)).astype(np.float32),
                 (rng.random((n, D)) < 0.6).astype(np.float32))
                for n in (1, 5)]
    jsrv = jserve.ImputationServer(jp, jc, D, buckets=(1, 8),
                                   mesh=_jmesh(2, 1))
    want = [jsrv.impute(x, m) for x, m in requests]
    noise = _jax_noise(tc)
    draws = _record(noise, [("eps", 1, (2, L)), ("eps", 2, (8, L))])
    job = ("serve", dict(cfg=_kw(tc), params=_flat(tp), obs_dim=D,
                         buckets=(1, 8), requests=requests, draws=draws))
    http = ("http", dict(cfg=_kw(tc), params=_flat(tp), obs_dim=D,
                         requests=requests))
    return job, http, (want, jsrv.buckets)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_al_ais")
    cases = {**_al_cases(tmp), **_ais_cases(tmp)}
    serve_job, http_job, serve_want = _serve_case()
    jobs = {name: job for name, (job, _) in cases.items()}
    jobs.update(serve=serve_job, http=http_job,
                dryrun=("dryrun_multichip", {}))
    got = worker.spawn(list(jobs.values()), 2, tmp / "pg")
    want = {name: w for name, (_, w) in cases.items()}
    want["serve"] = serve_want
    return [dict(zip(jobs, r)) for r in got], want, tmp


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("name", ["al", "al_ensemble"])
def test_al_episode_on_dp_2_matches_jax_s_padded_run(ranks, name):
    """17 test rows padded to 18: on both ranks the reveals, rewards,
    imputations and curve of the real rows are JAX's mesh episode's; rank
    0 alone writes, JAX's files at JAX's shapes."""
    got, want, tmp = ranks
    w = want[name]
    reward_tol, im_atol, (curve_rtol, curve_atol) = AL_TOLS[name]
    serial_al._assert_gaps(w["R_hist"], reward_tol)
    for rank in got:
        out = rank[name]["out"]
        for k in tal.ARTIFACTS:
            assert out[k].shape == w[k].shape, k
        np.testing.assert_array_equal(out["action"], w["action"])
        err = np.abs(out["R_hist"] - w["R_hist"])
        assert (err <= reward_tol(w["R_hist"])).all(), err.max()
        np.testing.assert_allclose(out["im"], w["im"], rtol=0, atol=im_atol)
        np.testing.assert_allclose(out["information_curve"],
                                   w["information_curve"], rtol=curve_rtol,
                                   atol=curve_atol)
    assert got[1][name]["writes"] == 0
    port, jax_root = tmp / f"port_{name}", tmp / f"jax_{name}"
    files = _tree(jax_root)
    assert _tree(port) == files
    assert got[0][name]["writes"] == len(files) - 1  # metrics.jsonl aside


def _real_decisions(steps, rank, B0, B0_run):
    """Each recorded step's log-space gaps on this rank's chains of real
    rows (chain s * B0_run + b is on row b)."""
    gaps = []
    for prob, u in steps:
        local = u.shape[-1]
        rows = (rank * local + np.arange(local)) % B0_run < B0
        gaps.append(np.abs(np.log(prob) - np.log(u))[..., rows].ravel())
    return np.concatenate(gaps)


@pytest.mark.parametrize("name", ["ais_batch", "bdmc", "eval_ais",
                                  "eval_ais_ensemble", "eval_bdmc"])
def test_ais_on_dp_2_matches_jax_s_padded_chains(ranks, name):
    """The chains dp-sharded (3 rows padded to 4 where 3 x 3 chains do not
    divide): every real chain's decision clears 1e-3 on each rank, then
    the estimates and latents are JAX's on both ranks; rank 0 alone
    writes, JAX's files."""
    got, want, tmp = ranks
    # (real rows, rows run) of a run's chains: 3 rows pad to 4, 2 do not
    rows = {"ais_batch": (ROWS, 4), "bdmc": (ROWS, 4), "eval_bdmc": (2, 2)}
    for r, rank in enumerate(got):
        res = rank[name]
        if name in rows:
            gaps = _real_decisions(res["steps"], r, *rows[name])
        else:  # the train split (4 rows run), then the test split (2)
            half = len(res["steps"]) // 2
            gaps = np.concatenate([
                _real_decisions(res["steps"][:half], r, ROWS, 4),
                _real_decisions(res["steps"][half:], r, 2, 2)])
        assert (gaps > GAP).all(), f"a decision within {GAP}: {gaps.min()}"
        out, w = res["out"], want[name]
        if "lower" in w:
            for k in ("lower", "upper"):
                np.testing.assert_allclose(out[k], w[k], rtol=LOGW_RTOL)
            continue
        for stage, ws in (w.items() if "logw" not in w else [("", w)]):
            o = out[stage] if stage else out
            np.testing.assert_allclose(o["logw"], ws["logw"],
                                       rtol=LOGW_RTOL, err_msg=stage)
            assert o["latents"].shape == np.asarray(ws["latents"]).shape
            np.testing.assert_allclose(o["latents"], ws["latents"], rtol=0,
                                       atol=Z_ATOL, err_msg=stage)
    if name.startswith("eval"):
        assert got[1][name]["writes"] == 0
        files = _tree(tmp / f"jax_{name}")
        assert _tree(tmp / f"port_{name}") == files
        assert got[0][name]["writes"] == len(files) - 1


def test_served_requests_on_dp_2_match_the_jax_server(ranks):
    """Buckets rounded up to multiples of dp; a 1-row and a 5-row request
    imputed as JAX's mesh server imputes them, on both ranks."""
    got, want, _ = ranks
    answers, buckets = want["serve"]
    for rank in got:
        assert rank["serve"]["buckets"] == buckets == (2, 8)
        for (f, s), (wf, ws) in zip(rank["serve"]["out"], answers):
            np.testing.assert_allclose(f, wf, rtol=0, atol=CELL_ATOL)
            np.testing.assert_allclose(s, ws, rtol=SCORE_RTOL)


def test_http_on_two_ranks_broadcasts_each_request(ranks):
    """Rank 0 answers both POSTs; rank 1 served each of them, then
    stopped."""
    got, _, _ = ranks
    r0, r1 = got[0]["http"], got[1]["http"]
    assert r0["served"] == r1["served"] == 2
    for ans, n in zip(r0["answers"], (1, 5)):
        assert np.asarray(ans["imputed"]).shape == (n, D)
        assert np.isfinite(ans["row_score"]).all()


def test_dryrun_multichip_runs_every_mesh_path_on_two_ranks(ranks):
    """`parallel/dryrun.dryrun_multichip(2)`: every path's asserts pass on
    both ranks; rank 0 alone prints the summary."""
    got, _, _ = ranks
    r0, r1 = got[0]["dryrun"], got[1]["dryrun"]
    assert r0["line"] == r1["line"]
    assert r0["out"].strip() == r0["line"] and r1["out"] == ""
    assert r0["line"].startswith(
        "dryrun_multichip(2): mesh={'dp': 2, 'tp': 1}")

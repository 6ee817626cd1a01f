"""The port's active-learning engine against the JAX package's: the reward
math (`_chaini_kl`, `_flow_reward`), the `encode_stats` hook of each
family, `active_learning_paths`, and whole selection episodes of the
gauss, EDDI, flow and MIWAE families under JAX's replayed key tree
(`JaxALKeys`), with their saved artifacts."""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.engine import active_learning as jal
from vae_posterior_consistency_tpu.engine import artifacts as jart
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu.models import get_model as jget_model
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.engine import active_learning as tal
from vae_posterior_consistency_tpu_torch.engine import artifacts as tart
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.models import get_model
from test_torch_evaluate import JaxEvalKeys, _t

#: the wine width and test split's size
D, N = 13, 17
#: a reward against JAX's: the chaini 'KL' sums ten O(1) terms (variance
#: ratios, -1, log-variances) that cancel to the reward, each rounded in
#: float32 after 50- to 128-wide layers summed in another order, so about
#: 1e-6 absolute is left whatever the reward; a reward of size R carries
#: about 1e-5 R more from the statistics' relative rounding through exp
REWARD_ATOL = 2e-6
REWARD_RTOL = 3e-5
#: the imputations and the predictive-MSE curve: decoder outputs in [0, 1]
#: (a flow's and a MIWAE's means unbounded but of order 1) after the same
#: layers, and means of their squared errors
IM_ATOL = 1e-5
CURVE_RTOL = 1e-5
#: the flow's reward sums twenty |log q| differences of O(1-10)
#: log-densities of sampled z through three linear splines, each rounded
#: at about 1e-6. A z within float32 rounding of a spline knot takes the
#: adjacent bin in one package (ROADMAP C.4.6: the cdf bits of XLA and torch
#: differ; this seed meets one, a z of -0.0504 whose log-density moves by
#: 0.398), and its reward then moves by the log-ratio of the two bins'
#: densities over M: at most FLOW_KNOT_SHARE of the rewards may move so,
#: each by at most FLOW_KNOT_ATOL; every other reward keeps FLOW_ATOL
FLOW_ATOL = 1e-5
FLOW_KNOT_SHARE = 1e-3
FLOW_KNOT_ATOL = 0.5

#: vae_type: (M, Repeat, head scale, extra config). The head scale
#: multiplies a Gaussian-KL family's encoder output layer, so that its
#: posterior moves with each revealed feature as a trained model's does:
#: at the default init the statistics spread by 0.03-0.05 across the rows,
#: the rewards are about 1e-4 and their top-two gaps reach 2e-7, inside
#: float32 rounding, so no reveal order could be compared. Scaled, the
#: statistics spread by 0.4-0.9 (EDDI's sum-pooled trunk starts at twice
#: the dense encoders' spread, so a third of their scale); the flow's
#: rewards are O(1) as they stand.
EPISODES = {
    "vanilla_vae1": (2, 2, 30.0, {}),
    "reg_EDDI1": (2, 1, 10.0, {}),
    "reg_flow1": (2, 1, 1.0, {"hid_dim": 32}),
    "reg_MIWAE1": (2, 1, 30.0, {"valid_k": 20}),
}


class JaxALKeys:
    """Replays the JAX episode's key tree (engine/active_learning.py:184-306)
    as a port noise source: rkey = fold_in(key, r); (k_maskp, k_run) =
    split(rkey); (k_init, k_loop) = split(k_run). "init": split(k_init, M).
    Step t: k_t = fold_in(k_loop, t), (k_im, k_r, k_mse) = split(k_t, 3);
    "im" split(k_im, M), "mse" split(k_mse, M), each sample's key feeding
    the family's eval_step draws (`JaxEvalKeys.eps`); "flow": candidate u's
    key split(k_r, D-1)[u], sample m's fold_in(., m), split in 4 for (lp,
    lp_u, lp_t, lp_tu), each a normal [n, L]."""

    def __init__(self, key, cfg):
        self.key = key
        self.eps = JaxEvalKeys(None, cfg).eps

    def __call__(self, kind, repeat, step, shape):
        _, k_run = jax.random.split(jax.random.fold_in(self.key, repeat))
        k_init, k_loop = jax.random.split(k_run)
        if kind == "init":
            keys = jax.random.split(k_init, shape[0])
        else:
            k_im, k_r, k_mse = jax.random.split(
                jax.random.fold_in(k_loop, step), 3)
            if kind == "flow":
                return self._flow(k_r, shape)
            keys = jax.random.split({"im": k_im, "mse": k_mse}[kind],
                                    shape[0])
        return torch.stack([self.eps(k, tuple(shape[1:])) for k in keys])

    @staticmethod
    def _flow(k_r, shape):
        _, U, M, n, L = shape

        def per_sample(k_u, m):
            ks = jax.random.split(jax.random.fold_in(k_u, m), 4)
            return jax.vmap(lambda k: jax.random.normal(k, (n, L)))(ks)

        draws = jax.vmap(lambda k_u: jax.vmap(
            lambda m: per_sample(k_u, m))(jnp.arange(M)))(
                jax.random.split(k_r, U))  # [U, M, 4, n, L]
        return _t(jnp.transpose(draws, (2, 0, 1, 3, 4)))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (N, D)).astype(np.float32)
    mask = (rng.random((N, D)) < 0.7).astype(np.float32)
    return x, mask


def _params(jc, head_scale=1.0, seed=7):
    """Seeded JAX parameters, the encoder's output layer scaled by
    `head_scale`, and their port copy on the CPU."""
    jparams = jget_model(jc).init(jax.random.PRNGKey(seed), jc, D)
    flat = {k: np.asarray(v) for k, v in jckpt._flatten(jparams).items()}
    heads = [k for k in flat if k.startswith("encoder/") and k.endswith("/w")]
    head = max(heads, key=lambda k: ("pnp2" in k, k))
    flat[head] = flat[head] * np.float32(head_scale)

    def rebuild(path, _):
        return jnp.asarray(flat["/".join(
            str(getattr(p, "key", getattr(p, "idx", None))) for p in path)])

    return (jax.tree_util.tree_map_with_path(rebuild, jparams),
            tckpt.params_from_jax(flat, "cpu"))


def _reward_tol(R):
    return REWARD_ATOL + REWARD_RTOL * np.abs(R)


def _assert_gaps(R, tol):
    """Every row's top-two gap among its hidden candidates, at every step,
    exceeds the reward tolerance `tol(top reward)`: otherwise a reveal
    could flip on rounding and the episodes could not be compared."""
    for idx in np.ndindex(R.shape[:-1]):
        hidden = np.sort(R[idx][R[idx] > tal.NEG_INF_REWARD])[::-1]
        if len(hidden) > 1:
            gap = hidden[0] - hidden[1]
            assert gap > tol(hidden[0]), (
                f"near-tie at (repeat, step, row) {idx}: gap {gap:.3e}, "
                f"tolerance {tol(hidden[0]):.3e}")


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    """Each family's episode run by both packages from the same parameters
    and keys, saved to a directory each."""
    cache = {}

    def run(vae_type):
        if vae_type not in cache:
            M, repeat, head_scale, extra = EPISODES[vae_type]
            kw = dict(vae_type=vae_type, M=M, seed=3, missing_rate=30,
                      **extra)
            jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
            jparams, tparams = _params(jc, head_scale)
            x, mask = _data()
            key = jax.random.PRNGKey(5)
            jroot = str(tmp_path_factory.mktemp(f"jax_{vae_type}"))
            troot = str(tmp_path_factory.mktemp(f"port_{vae_type}"))
            want = jal.active_learning_func(
                None, x, mask, jc, experiments_root=jroot, Repeat=repeat,
                params=jparams, key=key)
            got = tal.active_learning_func(
                None, x, mask, tc, experiments_root=troot, Repeat=repeat,
                params=tparams, noise=JaxALKeys(key, tc), device="cpu")
            cache[vae_type] = dict(
                jc=jc, tc=tc, jroot=jroot, troot=troot,
                want={k: np.asarray(v) for k, v in want.items()},
                got={k: v.numpy() for k, v in got.items()})
        return cache[vae_type]

    return run


def test_chaini_kl_matches_jax():
    rng = np.random.default_rng(1)
    args = [rng.normal(0.0, 1.0, (3, N, 10)).astype(np.float32)
            for _ in range(4)]
    want = np.asarray(jal._chaini_kl(*map(jnp.asarray, args)))
    got = tal._chaini_kl(*map(torch.from_numpy, args)).numpy()
    # ten terms of a row in another order: float32 rounding of their sum
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    # the quirk: the mean term divides by exp(logvar / 2), not exp(logvar)
    mean, logvar = torch.zeros(1, 1), torch.full((1, 1), 2.0)
    quirk = tal._chaini_kl(mean, logvar, mean + 1.0, logvar)
    assert quirk.item() == pytest.approx(0.5 / np.exp(1.0), rel=1e-6)


def test_flow_reward_matches_jax():
    kw = dict(vae_type="reg_flow1", hid_dim=32, seed=1)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    jparams, tparams = _params(jc)
    x, mask = _data(2)
    u = np.eye(D, dtype=np.float32)[[4]]
    last = np.eye(D, dtype=np.float32)[[D - 1]]
    key = jax.random.PRNGKey(9)
    want = np.asarray(jal._flow_reward(
        jget_model(jc), jparams, jc, jnp.asarray(x), jnp.asarray(mask),
        jnp.asarray(u), jnp.asarray(last), key))
    eps = torch.stack([_t(jax.random.normal(k, (N, tc.latent_dim)))
                       for k in jax.random.split(key, 4)])
    got = tal._flow_reward(get_model(tc), tparams, tc, torch.from_numpy(x),
                           torch.from_numpy(mask), torch.from_numpy(u),
                           torch.from_numpy(last[0]), eps).numpy()
    assert got.shape == (N,)
    # sums of ten |log q| differences of O(1) log-densities
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("vae_type", ["vanilla_vae1", "reg_vae1_mask_augm",
                                      "reg_EDDI1", "reg_MIWAE1",
                                      "vanilla_notMIWAE1", "reg_flow1"])
def test_encode_stats_matches_jax(vae_type):
    """gauss (dense, mask-augmented, EDDI through B2f's plain version),
    MIWAE (2 log scale), notMIWAE; the flow has no hook in either."""
    jc = jcfg.RunConfig(vae_type=vae_type, hid_dim=32)
    tc = tcfg.RunConfig(vae_type=vae_type, hid_dim=32)
    jmodel, tmodel = jget_model(jc), get_model(tc)
    if jmodel.encode_stats is None:
        assert tmodel.encode_stats is None
        assert tmodel.encode_sample_logprob is not None
        return
    jparams, tparams = _params(jc)
    x, mask = _data(3)
    want = jmodel.encode_stats(jparams, jnp.asarray(x), jnp.asarray(mask),
                               jc)
    got = tmodel.encode_stats(tparams, torch.from_numpy(x),
                              torch.from_numpy(mask), tc)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (N, tc.latent_dim)
        # statistics after 50- to 128-wide float32 layers
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(vae_type="vanilla_vae1", missing_rate=30),
    dict(vae_type="reg_EDDI1", missing_rate=30, alpha=1.0,
         p_missingness=30),
    dict(vae_type="vanilla_EDDI1_with_drop", missing_rate=30),
    dict(vae_type="reg_MIWAE1", missing_rate=50, alpha=0.5,
         p_missingness=30, reg_type="ml_reg"),
])
def test_active_learning_paths_match_jax(kw):
    want = jart.active_learning_paths(jcfg.RunConfig(**kw), "root")
    got = tart.active_learning_paths(tcfg.RunConfig(**kw), "root")
    assert got == want
    assert list(got) == ["information_curve", "action", "R_hist", "im"]


@pytest.mark.parametrize("vae_type", sorted(EPISODES))
def test_episode_matches_jax(episodes, vae_type):
    """R_hist and the imputations within tolerance, the actions equal, the
    information curve within tolerance, once every top-two gap clears the
    reward tolerance."""
    run = episodes(vae_type)
    want, got = run["want"], run["got"]
    M, repeat, _, _ = EPISODES[vae_type]
    flow = vae_type == "reg_flow1"
    _assert_gaps(want["R_hist"], (lambda R: FLOW_ATOL) if flow
                 else _reward_tol)
    np.testing.assert_array_equal(got["action"], want["action"])
    err = np.abs(got["R_hist"] - want["R_hist"])
    if flow:
        off = err > FLOW_ATOL
        assert off.mean() <= FLOW_KNOT_SHARE, np.argwhere(off)
        assert err.max() <= FLOW_KNOT_ATOL, err.max()
    else:
        off = err > _reward_tol(want["R_hist"])
        assert not off.any(), (err.max(), np.argwhere(off)[:5])
    np.testing.assert_allclose(got["im"], want["im"], rtol=0, atol=IM_ATOL)
    np.testing.assert_allclose(got["information_curve"],
                               want["information_curve"], rtol=CURVE_RTOL,
                               atol=1e-7)
    assert got["im"].shape == (repeat, D - 1, M, N, D)


@pytest.mark.parametrize("vae_type", sorted(EPISODES))
def test_saved_artifacts_match_jax_in_names_shapes_and_dtypes(episodes,
                                                              vae_type):
    run = episodes(vae_type)
    jpaths = jart.active_learning_paths(run["jc"], run["jroot"])
    tpaths = tart.active_learning_paths(run["tc"], run["troot"])
    for name in tal.ARTIFACTS:
        assert (os.path.relpath(tpaths[name], run["troot"])
                == os.path.relpath(jpaths[name], run["jroot"]))
        want = torch.load(jpaths[name], weights_only=False)
        got = torch.load(tpaths[name], weights_only=True)
        assert isinstance(got, torch.Tensor)
        assert got.dtype == want.dtype == torch.float32, name
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.numpy(), run["got"][name])
    # al_final_mse, one value a repeat, as JAX logs it
    recs = []
    for root in (run["jroot"], run["troot"]):
        path = os.path.join(root, run["tc"].experiment_type,
                            run["tc"].data_type, "metrics.jsonl")
        with open(path) as fh:
            recs.append([json.loads(line) for line in fh])
    (jrec,), (trec,) = recs
    for field in ("vae_type", "stage", "metric", "alpha", "p_missingness",
                  "missing_rate", "reg_type"):
        assert trec[field] == jrec[field], field
    assert trec["metric"] == "al_final_mse" and trec["stage"] == "test"
    np.testing.assert_allclose(trec["value"], jrec["value"],
                               rtol=CURVE_RTOL)


@pytest.mark.parametrize("vae_type", sorted(EPISODES))
def test_each_feature_is_revealed_exactly_once(episodes, vae_type):
    actions = episodes(vae_type)["got"]["action"]  # [R, n, D-1]
    for row in actions.reshape(-1, D - 1):
        assert sorted(row.astype(int).tolist()) == list(range(D - 1))


@pytest.mark.parametrize("vae_type", sorted(EPISODES))
def test_revealed_rewards_are_the_filler(episodes, vae_type):
    run = episodes(vae_type)
    R = run["got"]["R_hist"]  # [R, D-1, n, D-1]
    actions = run["got"]["action"].astype(int)
    for r in range(R.shape[0]):
        for t in range(D - 1):
            revealed = actions[r, :, :t]  # [n, t]
            for i in range(N):
                row = R[r, t, i]
                assert (row[revealed[i]] == tal.NEG_INF_REWARD).all()
                assert (row > tal.NEG_INF_REWARD).sum() == D - 1 - t
    # the last step leaves one candidate a row
    assert ((R[:, -1] == -1e4).sum(axis=-1) == D - 2).all()


def test_al_step_from_a_mask_matches_the_episode(episodes):
    """`al_step` from the episode's mask before step t gives that step's
    outputs: the unit the smoke compares card against CPU."""
    run = episodes("reg_EDDI1")
    tc = run["tc"]
    _, tparams = _params(run["jc"], EPISODES["reg_EDDI1"][2])
    x = torch.from_numpy(_data()[0])
    keys = JaxALKeys(jax.random.PRNGKey(5), tc)
    actions = torch.from_numpy(run["got"]["action"][0]).long()
    t = 4
    mask = torch.nn.functional.one_hot(actions[:, :t], D).sum(1).float()
    with torch.no_grad():
        out = tal.al_step(get_model(tc), tparams, tc, x, mask, keys, 0, t)
    np.testing.assert_array_equal(out["R"].numpy(), run["got"]["R_hist"][0, t])
    np.testing.assert_array_equal(out["im"].numpy(), run["got"]["im"][0, t])
    assert out["mse"].item() == run["got"]["information_curve"][0, 0, t + 1]
    assert torch.equal(out["mask"], mask + torch.nn.functional.one_hot(
        actions[:, t], D).float())


def test_default_noise_is_seeded_and_drawn_on_the_device():
    tc = tcfg.RunConfig(vae_type="vanilla_vae1", M=2, seed=4)
    _, tparams = _params(jcfg.RunConfig(vae_type="vanilla_vae1"))
    x, mask = _data()
    first = tal.active_learning_func(None, x, mask, tc, params=tparams,
                                     save=False, device="cpu")
    again = tal.active_learning_func(None, x, mask, tc, params=tparams,
                                     save=False, device="cpu")
    for name in tal.ARTIFACTS:
        assert torch.equal(first[name], again[name]), name
    other = tal.active_learning_func(None, x, mask, tc.replace(seed=5),
                                     params=tparams, save=False,
                                     device="cpu")
    assert not torch.equal(first["im"], other["im"])


def test_mesh_and_a_missing_checkpoint_raise(tmp_path):
    """A one-device mesh runs the single-device episode (nothing padded,
    no reduce), bit for bit; a missing checkpoint raises with its path."""
    from torch_dist_worker import one_rank_mesh

    tc = tcfg.RunConfig(vae_type="vanilla_vae1", M=2)
    x, mask = _data()
    _, tparams = _params(jcfg.RunConfig(vae_type="vanilla_vae1", M=2))
    plain = tal.active_learning_func(None, x, mask, tc, params=tparams,
                                     save=False, device="cpu")
    with one_rank_mesh() as mesh:
        meshed = tal.active_learning_func(None, x, mask, tc, params=tparams,
                                          save=False, mesh=mesh,
                                          device="cpu")
    for name in tal.ARTIFACTS:
        assert torch.equal(plain[name], meshed[name]), name
    path = tckpt.checkpoint_path(tc, str(tmp_path))
    with pytest.raises(FileNotFoundError, match=re.escape(path)):
        tal.active_learning_func(None, x, mask, tc,
                                 experiments_root=str(tmp_path),
                                 device="cpu")

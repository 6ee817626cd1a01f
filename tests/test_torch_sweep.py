"""The port's ensemble trainers (`parallel/sweep`) against the JAX package's
under replayed keys: the five trainers in parameters and loss history, one
vmapped step of the flow, MIWAE and notMIWAE families, group splitting,
ragged splits, resume bit for bit and resume files both ways, and
per-replica early stopping (mirroring tests/test_parallel.py:1147-1255).

The JAX ensembles' keys (parallel/sweep.py:151-190, 243-284) are replayed by
`JaxEnsembleKeys` (training) and `JaxValKeys(PRNGKey(cfg.seed), cfg)`
(validation); the initial parameters are JAX's `_stacked_init`. Tolerance:
the JAX package's ensemble and the port's run the same float32 arithmetic
in other summation orders, held as test_torch_train.train_against_jax holds
the serial trainer (every weight within lr per step, at most one in a
thousand more than 1e-5 apart; losses at rtol 1e-4). TF32 plays no part:
these run on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu.models import get_model as jget_model
from vae_posterior_consistency_tpu.parallel import sweep as jsweep
from vae_posterior_consistency_tpu.utils import early_stopping as jes
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.engine import train as ttrain
from vae_posterior_consistency_tpu_torch.ops import _kernel
from vae_posterior_consistency_tpu_torch.parallel import sweep as tsweep
from vae_posterior_consistency_tpu_torch.utils import early_stopping as tes
from test_torch_resume import FEW_APART, HIST_RTOL, JaxValKeys, _datasets
from test_torch_train import _t, model_noise

#: the JAX package's stream tags (parallel/sweep.py:170)
TAGS = {"split": 13, "alpha": 7}


class JaxEnsembleKeys:
    """Replays a JAX ensemble's training keys (parallel/sweep.py:151-190) as
    a port ensemble noise source. seed mode: replica r's epoch key
    fold_in(PRNGKey(seeds[r]), epoch), split into (kperm, kstep), its step
    key split(fold_in(kstep, s)) = (k_mask, k_model). split and alpha
    modes: one epoch key fold_in(PRNGKey(cfg.seed + tag), epoch), one
    permutation, the step base fold_in(kstep, s); alpha splits it into
    (k_mask, k_model) for every replica, split folds in the replica index
    first. The draws from (k_mask, k_model) are a serial step's
    (test_torch_train.JaxKeyStream)."""

    def __init__(self, mode, cfg, S, seeds=None):
        self.mode, self.cfg, self.S = mode, cfg, S
        self.seeds = None if seeds is None else [int(s) for s in seeds]

    def group(self, lo, hi):
        seeds = self.seeds[lo:hi]
        return JaxEnsembleKeys("seed", self.cfg, len(seeds), seeds)

    def _draw(self, kind, k_mask, k_model, shape):
        if kind == "mask_p":
            return _t(jax.random.uniform(k_mask, shape))
        if kind == "drop":
            return _t(jnp.stack([jax.random.uniform(k, shape[1:])
                                 for k in jax.random.split(k_mask)]))
        return model_noise(k_model, self.cfg, kind, shape)

    def epoch(self, epoch, n, steps, shapes):
        if self.mode == "seed":
            perms, keys = [], []
            for s in self.seeds:
                kperm, kstep = jax.random.split(
                    jax.random.fold_in(jax.random.PRNGKey(s), epoch))
                perms.append(_t(jax.random.permutation(kperm, n)).long())
                keys.append([jax.random.split(jax.random.fold_in(kstep, st))
                             for st in range(steps)])
            out = {"perm": torch.stack(perms)}
            for kind, shape in shapes.items():
                out[kind] = torch.stack([torch.stack([
                    self._draw(kind, *keys[r][st], shape)
                    for r in range(self.S)]) for st in range(steps)])
            return out
        ekey = jax.random.fold_in(
            jax.random.PRNGKey(self.cfg.seed + TAGS[self.mode]), epoch)
        kperm, kstep = jax.random.split(ekey)
        out = {"perm": _t(jax.random.permutation(kperm, n)).long()}
        bases = [jax.random.fold_in(kstep, st) for st in range(steps)]
        for kind, shape in shapes.items():
            if self.mode == "alpha":
                out[kind] = torch.stack([
                    self._draw(kind, *jax.random.split(b), shape)
                    for b in bases])
            else:
                out[kind] = torch.stack([torch.stack([
                    self._draw(kind, *jax.random.split(
                        jax.random.fold_in(b, r)), shape)
                    for r in range(self.S)]) for b in bases])
        return out


def _cfgs(vae_type, **kw):
    kw = dict(vae_type=vae_type, batch_size=8, seed=3, latent_dim=4, **kw)
    return jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)


def _jax_init(jc, obs_dim, init_keys):
    """JAX's stacked init as the port's parameters."""
    stacked = jsweep._stacked_init(jget_model(jc), jc, obs_dim, init_keys)
    return tckpt.params_from_jax(jckpt._flatten(stacked), "cpu")


def _fold_keys(seed, S):
    return jax.vmap(jax.random.fold_in, (None, 0))(jax.random.PRNGKey(seed),
                                                   jnp.arange(S))


def _seed_keys(seeds):
    return jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.uint32))


def _close(got, want, steps):
    """test_torch_train.train_against_jax's tolerance, on stacked
    parameters."""
    got, want = tckpt.flatten(got), jckpt._flatten(want)
    assert sorted(got) == sorted(want)
    diffs = np.concatenate([np.abs(got[k].numpy() - np.asarray(want[k])
                                   ).ravel() for k in got])
    assert diffs.max() <= ttrain.LEARNING_RATE * steps, diffs.max()
    assert np.mean(diffs > 1e-5) <= FEW_APART, np.sort(diffs)[-10:]


def _equal(a, b):
    a, b = tckpt.flatten(a), tckpt.flatten(b)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k].cpu(), b[k].cpu()), k


#: 20 rows at batch 8: 3 steps an epoch, 4 rows wrap-padded
N, D, STEPS_PER_EPOCH = 20, 6, 3

TYPES = [("reg_vae1", {"reg_type": "kl_reg"}), ("reg_EDDI1", {})]


@pytest.mark.parametrize("vae_type,extra", TYPES)
def test_seed_ensemble_reproduces_jax(vae_type, extra):
    jc, tc = _cfgs(vae_type, epoch=2, **extra)
    jds, tds = _datasets(N, D)
    seeds = [0, 1, 2]
    want_p, want_h = jsweep.train_seed_ensemble(jds, jc, seeds)
    got_p, got_h = tsweep.train_seed_ensemble(
        tds, tc, seeds, device="cpu",
        noise=JaxEnsembleKeys("seed", tc, 3, seeds),
        params=_jax_init(jc, D, _seed_keys(seeds)))
    assert got_h.shape == want_h.shape == (3, 2)
    np.testing.assert_allclose(got_h, want_h, rtol=HIST_RTOL)
    _close(got_p, want_p, 2 * STEPS_PER_EPOCH)


@pytest.mark.parametrize("vae_type,extra", TYPES)
def test_split_ensemble_reproduces_jax_with_seeds_and_ragged_splits(
        vae_type, extra):
    """Three splits, the last ragged (14 rows, wrap-padded to 20), repeated
    over n_seeds=2: six rows, seed-major."""
    jc, tc = _cfgs(vae_type, epoch=2, **extra)
    pairs = [_datasets(N, D, seed=1), _datasets(N, D, seed=2),
             _datasets(14, D, seed=3)]
    jdss, tdss = [p[0] for p in pairs], [p[1] for p in pairs]
    want_p, want_h = jsweep.train_split_ensemble(jdss, jc, n_seeds=2)
    got_p, got_h = tsweep.train_split_ensemble(
        tdss, tc, n_seeds=2, device="cpu",
        noise=JaxEnsembleKeys("split", tc, 6),
        params=_jax_init(jc, D, _fold_keys(jc.seed, 6)))
    assert got_h.shape == want_h.shape == (6, 2)
    np.testing.assert_allclose(got_h, want_h, rtol=HIST_RTOL)
    _close(got_p, want_p, 2 * STEPS_PER_EPOCH)


@pytest.mark.parametrize("vae_type,extra", TYPES)
def test_alpha_ensemble_reproduces_jax(vae_type, extra):
    jc, tc = _cfgs(vae_type, epoch=2, **extra)
    jds, tds = _datasets(N, D)
    alphas = [0.0, 0.5, 2.0]
    want_p, want_h = jsweep.train_alpha_ensemble(jds, jc, alphas, seed=5)
    got_p, got_h = tsweep.train_alpha_ensemble(
        tds, tc, alphas, seed=5, device="cpu",
        noise=JaxEnsembleKeys("alpha", tc.replace(seed=5), 3),
        params=_jax_init(jc, D, _fold_keys(5, 3)))
    np.testing.assert_allclose(got_h, want_h, rtol=HIST_RTOL)
    _close(got_p, want_p, 2 * STEPS_PER_EPOCH)
    # alpha is the only difference between the replicas
    assert not np.allclose(got_h[0], got_h[2])


@pytest.mark.parametrize("vae_type,extra", TYPES)
def test_alpha_seed_ensemble_reproduces_jax(vae_type, extra):
    jc, tc = _cfgs(vae_type, epoch=2, **extra)
    jds, tds = _datasets(N, D)
    alphas, seeds = [0.5, 1.0], [4, 9]
    row_seeds = [sd for _ in alphas for sd in seeds]
    want_p, want_h = jsweep.train_alpha_seed_ensemble(jds, jc, alphas, seeds)
    got_p, got_h = tsweep.train_alpha_seed_ensemble(
        tds, tc, alphas, seeds, device="cpu",
        noise=JaxEnsembleKeys("seed", tc, 4, row_seeds),
        params=_jax_init(jc, D, _seed_keys(row_seeds)))
    np.testing.assert_allclose(got_h, want_h, rtol=HIST_RTOL)
    _close(got_p, want_p, 2 * STEPS_PER_EPOCH)


@pytest.mark.parametrize("seeds", [None, [0, 1]])
@pytest.mark.parametrize("vae_type,extra", TYPES)
def test_sweep_ensemble_reproduces_jax(vae_type, extra, seeds):
    """Two missing rates x two alphas (x two seeds): the rates enter only
    the mask_p threshold; without seeds the rows share the uniforms."""
    jc, tc = _cfgs(vae_type, epoch=2, **extra)
    jds, tds = _datasets(N, D)
    missings, alphas = [20, 60], [0.5, 1.0]
    want_p, want_h, want_rows = jsweep.train_sweep_ensemble(
        jds, jc, missings=missings, alphas=alphas, seeds=seeds)
    R = len(want_rows)
    if seeds is None:
        noise = JaxEnsembleKeys("alpha", tc, R)
        keys = _fold_keys(jc.seed, R)
    else:
        row_seeds = [s for _, _, s in want_rows]
        noise = JaxEnsembleKeys("seed", tc, R, row_seeds)
        keys = _seed_keys(row_seeds)
    got_p, got_h, got_rows = tsweep.train_sweep_ensemble(
        tds, tc, missings=missings, alphas=alphas, seeds=seeds, device="cpu",
        noise=noise, params=_jax_init(jc, D, keys))
    assert got_rows == want_rows
    np.testing.assert_allclose(got_h, want_h, rtol=HIST_RTOL)
    _close(got_p, want_p, 2 * STEPS_PER_EPOCH)


def test_sweep_ensemble_with_one_rate_is_the_alpha_ensemble():
    """A singleton `missings` delegates (sweep.py:772-785): bit for bit
    the alpha ensemble at that rate."""
    _, tc = _cfgs("reg_vae1", epoch=2)
    _, tds = _datasets(N, D)
    p1, h1, rows = tsweep.train_sweep_ensemble(
        tds, tc, missings=[40], alphas=[0.5, 1.0], device="cpu")
    p2, h2 = tsweep.train_alpha_ensemble(
        tds, tc.replace(p_missingness=40), [0.5, 1.0], seed=tc.seed,
        device="cpu")
    assert rows == [(40, 0.5, None), (40, 1.0, None)]
    np.testing.assert_array_equal(h1, h2)
    _equal(p1, p2)


@pytest.mark.parametrize("vae_type,extra", [
    ("reg_flow1", {"hid_dim": 16, "flow_actnorm": True}),
    ("reg_MIWAE1", {"train_k": 3}),
    ("vanilla_MIWAE1", {"train_k": 3}),
    ("reg_notMIWAE1", {"train_k": 3}),
    ("reg_notMIWAE1", {"train_k": 3, "reg_notmiwae_variant": "sampled_mask"})])
def test_one_vmapped_step_of_each_family_matches_jax(vae_type, extra):
    """One epoch of one step (8 rows at batch 8) of a 2-seed ensemble: the
    flow's spline layers, the importance-weighted helpers and the notMIWAE
    missing process under torch.func.vmap, against JAX's vmapped step."""
    jc, tc = _cfgs(vae_type, epoch=1, **extra)
    jds, tds = _datasets(8, D)
    seeds = [0, 1]
    want_p, want_h = jsweep.train_seed_ensemble(jds, jc, seeds)
    got_p, got_h = tsweep.train_seed_ensemble(
        tds, tc, seeds, device="cpu",
        noise=JaxEnsembleKeys("seed", tc, 2, seeds),
        params=_jax_init(jc, D, _seed_keys(seeds)))
    np.testing.assert_allclose(got_h, want_h, rtol=HIST_RTOL)
    _close(got_p, want_p, 1)


def test_replicas_are_the_serial_runs_of_their_seeds_at_init():
    """The default init of replica i is `train`'s init of a run with seed
    seeds[i]; the replicas' streams are their own."""
    _, tc = _cfgs("reg_vae1", epoch=0)
    _, tds = _datasets(N, D)
    got, hist = tsweep.train_seed_ensemble(tds, tc, [3, 7], device="cpu")
    assert hist.shape == (2, 0)
    for i, s in enumerate((3, 7)):
        serial, _ = ttrain.train(tds, tc.replace(seed=s), device="cpu",
                                 save=False)
        _equal(tsweep.ensemble_replica(got, i), serial)


def test_cpu_ensembles_count_no_launch_and_cuda_needs_a_card():
    _, tc = _cfgs("reg_EDDI1", epoch=1)
    _, tds = _datasets(N, D)
    before = _kernel.launches.copy()
    _, hist = tsweep.train_seed_ensemble(tds, tc, [0, 1], device="cpu")
    assert np.isfinite(hist).all()
    assert _kernel.launches == before
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsweep.train_seed_ensemble(tds, tc, [0, 1])


# ---------------------------------------------------------------------------
# groups, resume
# ---------------------------------------------------------------------------


def test_seed_groups_draw_what_the_whole_ensemble_draws(monkeypatch):
    """SEED_GROUP_MAX_S monkeypatched to 2: five seeds train as groups of
    2, 2 and 1, each replica's draws keyed by its seed, and land where the
    one-group ensemble lands (rounding of other batch sizes aside), on the
    default noise and under JAX's keys alike."""
    _, tc = _cfgs("reg_vae1", epoch=2)
    _, tds = _datasets(N, D)
    seeds = [0, 1, 2, 3, 4]
    whole_p, whole_h = tsweep.train_seed_ensemble(tds, tc, seeds,
                                                  device="cpu")
    monkeypatch.setattr(tsweep, "SEED_GROUP_MAX_S", 2)
    grp_p, grp_h = tsweep.train_seed_ensemble(tds, tc, seeds, device="cpu")
    np.testing.assert_allclose(grp_h, whole_h, rtol=1e-5, atol=1e-5)
    for k, v in tckpt.flatten(whole_p).items():
        np.testing.assert_allclose(tckpt.flatten(grp_p)[k].numpy(),
                                   v.numpy(), rtol=1e-4, atol=1e-5)
    jc, tc = _cfgs("reg_vae1", epoch=1)
    jds, _ = _datasets(N, D)
    want_p, want_h = jsweep.train_seed_ensemble(jds, jc, seeds)
    got_p, got_h = tsweep.train_seed_ensemble(
        tds, tc, seeds, device="cpu",
        noise=JaxEnsembleKeys("seed", tc, 5, seeds),
        params=_jax_init(jc, D, _seed_keys(seeds)))
    np.testing.assert_allclose(got_h, want_h, rtol=HIST_RTOL)
    _close(got_p, want_p, STEPS_PER_EPOCH)


def test_grouped_resume_pads_the_histories_of_groups_that_ran_nothing(
        tmp_path, monkeypatch):
    """tests/test_parallel.py:1110-1144 in the port: group 1's resume file
    removed, the resumed run retrains group 1 only; its parameters equal
    the uninterrupted run's bit for bit, group 0's history is NaN."""
    _, tc = _cfgs("vanilla_vae1", epoch=4)
    _, tds = _datasets(N, D)
    monkeypatch.setattr(tsweep, "SEED_GROUP_MAX_S", 2)
    rp = str(tmp_path / "ens.resume.pt")
    p_full, h_full = tsweep.train_seed_ensemble(
        tds, tc, [0, 1, 2, 3], chunk_epochs=2, checkpoint_every=2,
        resume_path=rp, device="cpu")
    assert os.path.exists(rp + ".g0") and os.path.exists(rp + ".g1")
    os.remove(rp + ".g1")
    p_res, h_res = tsweep.train_seed_ensemble(
        tds, tc, [0, 1, 2, 3], chunk_epochs=2, checkpoint_every=2,
        resume_path=rp, resume=True, device="cpu")
    _equal(p_full, p_res)
    assert h_res.shape == h_full.shape
    assert np.isnan(h_res[:2]).all()
    np.testing.assert_array_equal(h_res[2:], h_full[2:])


@pytest.mark.parametrize("trainer", ["seed", "split", "sweep"])
def test_resumed_ensemble_equals_the_straight_one_bit_for_bit(tmp_path,
                                                              trainer):
    """4 epochs straight against 2 epochs with checkpoint_every=2 then
    resume to 4, on the default noise: the same parameters and the same
    losses of epochs 3-4, bit for bit on the CPU."""
    _, tc = _cfgs("reg_EDDI1", epoch=4)
    _, tds = _datasets(N, D)
    _, tds2 = _datasets(N, D, seed=2)

    def run(cfg, **kw):
        if trainer == "seed":
            return tsweep.train_seed_ensemble(tds, cfg, [0, 1], device="cpu",
                                              chunk_epochs=2, **kw)
        if trainer == "split":
            return tsweep.train_split_ensemble([tds, tds2], cfg,
                                               device="cpu", chunk_epochs=2,
                                               **kw)
        return tsweep.train_sweep_ensemble(
            tds, cfg, missings=[20, 40], alphas=[1.0], device="cpu",
            chunk_epochs=2, **kw)[:2]

    rp = str(tmp_path / "ens.resume.pt")
    straight, h_straight = run(tc)
    run(tc.replace(epoch=2), checkpoint_every=2, resume_path=rp)
    resumed, h_resumed = run(tc, checkpoint_every=2, resume_path=rp,
                             resume=True)
    np.testing.assert_array_equal(h_resumed, h_straight[:, 2:])
    _equal(straight, resumed)
    assert int(torch.load(rp, weights_only=False)["epoch"]) == 4


def test_ensemble_resume_files_load_in_both_packages(tmp_path):
    """A JAX seed ensemble's resume file (2 epochs) resumed by the port
    under JAX's keys lands where JAX's straight 4-epoch ensemble lands; the
    port's file has JAX's keys and shapes and resumes in JAX to where the
    port's straight run lands."""
    jc, tc = _cfgs("reg_vae1", epoch=4)
    jds, tds = _datasets(N, D)
    seeds = [0, 1]
    tag_rp = str(tmp_path / "jax.resume.pt")
    want_p, want_h = jsweep.train_seed_ensemble(jds, jc, seeds,
                                                chunk_epochs=2)
    jsweep.train_seed_ensemble(jds, jc.replace(epoch=2), seeds,
                               chunk_epochs=2, checkpoint_every=2,
                               resume_path=tag_rp)
    noise = JaxEnsembleKeys("seed", tc, 2, seeds)
    init = _jax_init(jc, D, _seed_keys(seeds))
    got_p, got_h = tsweep.train_seed_ensemble(
        tds, tc, seeds, chunk_epochs=2, checkpoint_every=2, resume=True,
        resume_path=tag_rp, device="cpu", noise=noise, params=init)
    np.testing.assert_allclose(got_h, want_h[:, 2:], rtol=HIST_RTOL)
    _close(got_p, want_p, 4 * STEPS_PER_EPOCH)

    port_rp = str(tmp_path / "port.resume.pt")
    straight, _ = tsweep.train_seed_ensemble(
        tds, tc, seeds, device="cpu", noise=noise, params=init)
    tsweep.train_seed_ensemble(
        tds, tc.replace(epoch=2), seeds, chunk_epochs=2, checkpoint_every=2,
        resume_path=port_rp, device="cpu", noise=noise, params=init)
    port_file = torch.load(port_rp, weights_only=False)
    jax_file = torch.load(tag_rp, weights_only=False)
    assert sorted(port_file) == sorted(jax_file)
    for k, v in jax_file.items():
        assert np.asarray(port_file[k]).shape == np.asarray(v).shape, k
        assert np.asarray(port_file[k]).dtype == np.asarray(v).dtype, k
    assert int(port_file["tag"]) == int(jax_file["tag"])
    jax_res, _ = jsweep.train_seed_ensemble(
        jds, jc, seeds, chunk_epochs=2, checkpoint_every=2, resume=True,
        resume_path=port_rp)
    _close(straight, jax_res, 4 * STEPS_PER_EPOCH)


def test_restart_flags_without_a_resume_path_are_refused():
    _, tc = _cfgs("reg_vae1", epoch=1)
    _, tds = _datasets(N, D)
    for kw in ({"checkpoint_every": 1}, {"resume": True}):
        with pytest.raises(ValueError, match="require resume_path"):
            tsweep.train_seed_ensemble(tds, tc, [0], device="cpu", **kw)


def test_split_ensemble_refuses_a_mixed_obs_dim():
    _, tc = _cfgs("reg_vae1", epoch=1)
    _, a = _datasets(N, D)
    _, b = _datasets(N, D + 1)
    with pytest.raises(ValueError, match="one obs_dim"):
        tsweep.train_split_ensemble([a, b], tc, device="cpu")


def test_ragged_split_replica_trains_as_in_an_equal_group():
    """A replica whose split already has the group's largest row count
    trains exactly as in an all-equal group (sweep.py:549-561)."""
    _, tc = _cfgs("reg_vae1", epoch=2)
    _, a = _datasets(N, D, seed=1)
    _, b = _datasets(N, D, seed=2)
    _, c = _datasets(13, D, seed=3)
    p_rag, h_rag = tsweep.train_split_ensemble([a, b, c], tc, device="cpu")
    p_eq, h_eq = tsweep.train_split_ensemble([a, b, a], tc, device="cpu")
    np.testing.assert_array_equal(h_rag[:2], h_eq[:2])
    for k, v in tckpt.flatten(p_eq).items():
        assert torch.equal(tckpt.flatten(p_rag)[k][:2], v[:2]), k


# ---------------------------------------------------------------------------
# early stopping
# ---------------------------------------------------------------------------


def test_ensemble_early_stopping_per_replica_tracker():
    """tests/test_parallel.py:1147-1173 in the port: independent counters,
    best rows that mix checks, a stop only when every replica has used up
    its patience; the best rows are host copies of the improved rows."""
    es = tes.EnsembleEarlyStopping(patience=2)
    p1 = {"w": torch.arange(6, dtype=torch.float32).reshape(3, 2)}
    assert not es.update(np.array([3.0, 3.0, 3.0]), p1)
    np.testing.assert_array_equal(es.counter, [0, 0, 0])
    p2 = {"w": p1["w"] + 100}
    assert not es.update(np.array([3.0, 2.0, 4.0]), p2)
    np.testing.assert_array_equal(es.counter, [1, 0, 1])
    assert torch.equal(es.best_params["w"][0], p1["w"][0])
    assert torch.equal(es.best_params["w"][1], p2["w"][1])
    assert torch.equal(es.best_params["w"][2], p1["w"][2])
    p2["w"] += 1000  # training goes on in place: the copies stay
    assert torch.equal(es.best_params["w"][1], p1["w"][1] + 100)
    assert not es.update(np.array([5.0, 5.0, 5.0]), p2)
    np.testing.assert_array_equal(es.counter, [2, 1, 2])
    assert es.update(np.array([5.0, 5.0, 5.0]), p2)
    np.testing.assert_array_equal(es.best_loss, [3.0, 2.0, 3.0])
    fresh = es.clone_config()
    assert (fresh.patience, fresh.delta, fresh.best_loss) == (2, 0.0, None)


def test_seed_ensemble_early_stopping_stops_and_restores():
    """tests/test_parallel.py:1176-1201: delta=1e9 makes every check after
    the first a non-improvement; patience 2 stops at epoch 6 of 20 and
    returns the first check's parameters, equal bit for bit to the same
    ensemble trained only to that check."""
    _, tc = _cfgs("vanilla_vae1", epoch=20)
    _, tds = _datasets(N, D, n_test=7)
    es = tes.EnsembleEarlyStopping(patience=2, delta=1e9)
    params, hist = tsweep.train_seed_ensemble(tds, tc, [0, 1, 2],
                                              chunk_epochs=2,
                                              early_stopping=es,
                                              device="cpu")
    assert hist.shape == (3, 6)
    ref, _ = tsweep.train_seed_ensemble(tds, tc.replace(epoch=2), [0, 1, 2],
                                        chunk_epochs=2, device="cpu")
    _equal(params, ref)


def test_split_ensemble_early_stopping():
    """tests/test_parallel.py:1204-1227: per-replica validation tables,
    plateau stop and first-check restore."""
    _, tc = _cfgs("reg_vae1", epoch=20)
    tdss = [_datasets(N, D, n_test=7, seed=i)[1] for i in (1, 2, 3)]
    es = tes.EnsembleEarlyStopping(patience=1, delta=1e9)
    params, hist = tsweep.train_split_ensemble(tdss, tc, chunk_epochs=2,
                                               early_stopping=es,
                                               device="cpu")
    assert hist.shape == (3, 4)
    ref, _ = tsweep.train_split_ensemble(tdss, tc.replace(epoch=2),
                                         chunk_epochs=2, device="cpu")
    _equal(params, ref)


@pytest.mark.parametrize("vae_type", ["reg_vae1", "reg_EDDI1",
                                      "vanilla_EDDI1_with_drop"])
def test_sweep_ensemble_validation_matches_jax(vae_type):
    """The stacked validation objective under JAX's keys gives JAX's [R]
    losses, each row under its own alpha and missing rate
    (tests/test_parallel.py:1230-1252): the trackers' best losses after one
    check agree at rtol 1e-5 and differ across alpha rows."""
    jc, tc = _cfgs(vae_type, epoch=2)
    jds, tds = _datasets(N, D, n_test=7)
    missings, alphas = [20, 40], [0.5, 1.0]
    jtr = jes.EnsembleEarlyStopping(patience=1)
    _, _, rows = jsweep.train_sweep_ensemble(
        jds, jc, missings=missings, alphas=alphas, chunk_epochs=2,
        early_stopping=jtr)
    ttr = tes.EnsembleEarlyStopping(patience=1)
    tsweep.train_sweep_ensemble(
        tds, tc, missings=missings, alphas=alphas, chunk_epochs=2,
        early_stopping=ttr, device="cpu",
        noise=JaxEnsembleKeys("alpha", tc, len(rows)),
        params=_jax_init(jc, D, _fold_keys(jc.seed, len(rows))),
        val_noise=JaxValKeys(jax.random.PRNGKey(jc.seed), tc))
    np.testing.assert_allclose(ttr.best_loss, jtr.best_loss, rtol=1e-5)
    if vae_type.startswith("reg"):
        assert not np.isclose(ttr.best_loss[0], ttr.best_loss[1])

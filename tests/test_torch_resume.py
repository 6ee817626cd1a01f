"""Restartable training and early stopping in the port against the JAX
package: a resumed port run equals its uninterrupted run bit for bit; a
resume file of either package resumes in the other (the JAX package's
`.resume.pt` layout, Adam's state mapped to optax's count, mu and nu); the
refusals of tests/test_utils_extra.py:323-420; and early stopping stops at
JAX's epoch with JAX's best parameters under the replayed key stream,
validates at the same cadence whatever checkpoint_every is, and keeps its
best parameters while training goes on."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.data import loaders as jloaders
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu.engine import train as jtrain
from vae_posterior_consistency_tpu.models import get_model as jget_model
from vae_posterior_consistency_tpu.utils import early_stopping as jes
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.data import loaders as tloaders
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.engine import train as ttrain
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.utils import early_stopping as tes
from test_torch_train import JaxKeyStream, _t, model_noise

#: after the same Adam steps from the same state and noise the two packages'
#: parameters agree to float32 rounding except where a gradient component
#: is itself at rounding level, which Adam divides by its own size
#: (test_torch_train.train_against_jax): at most lr per step on any weight,
#: at most one weight in a thousand more than 1e-5 apart
FEW_APART = 1e-3
APART = 1e-5
#: the per-epoch loss sums of the two packages (test_torch_train)
HIST_RTOL = 1e-4


def _datasets(n=20, obs_dim=6, n_test=0, seed=1):
    """Tiny JAX and port datasets from one numpy draw (train, and a test
    split of n_test rows when n_test)."""
    rng = np.random.default_rng(seed)

    def draw(rows):
        x = rng.uniform(0.0, 1.0, (rows, obs_dim)).astype(np.float32)
        return x, (rng.random((rows, obs_dim)) < 0.7).astype(np.float32)

    splits = [("train", draw(n))] + ([("test", draw(n_test))] if n_test
                                     else [])
    jsplits = {st: jloaders.Split(jnp.asarray(x), jnp.asarray(m), st)
               for st, (x, m) in splits}
    tsplits = {st: tloaders.Split(torch.from_numpy(x), torch.from_numpy(m),
                                  st) for st, (x, m) in splits}
    return (jloaders.Dataset(train=jsplits["train"],
                             test=jsplits.get("test"), obs_dim=obs_dim),
            tloaders.Dataset(train=tsplits["train"],
                             test=tsplits.get("test"), obs_dim=obs_dim))


def _cfgs(vae_type, **kw):
    kw = dict(vae_type=vae_type, batch_size=8, seed=3, **kw)
    return jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)


def _tag(cfg):
    return f"run:{cfg.vae_type}:seed={cfg.seed}:batch={cfg.batch_size}"


def _close_params(got, want, steps):
    """The tolerance described at FEW_APART, for nested port parameters
    against a flat JAX dict."""
    got = tckpt.flatten(got)
    assert sorted(got) == sorted(want)
    diffs = np.concatenate([np.abs(got[k].numpy() - np.asarray(want[k])
                                   ).ravel() for k in got])
    assert diffs.max() <= ttrain.LEARNING_RATE * steps, diffs.max()
    assert np.mean(diffs > APART) <= FEW_APART, np.sort(diffs)[-10:]


@pytest.mark.parametrize("vae_type,extra", [
    ("reg_vae1", {}), ("vanilla_EDDI1_with_drop", {}),
    ("reg_flow1", {"flow_actnorm": True, "hid_dim": 16})])
def test_resumed_port_run_equals_the_uninterrupted_run_bit_for_bit(
        tmp_path, vae_type, extra):
    """6 epochs straight, against 3 epochs with checkpoint_every=3 and then
    -resume to 6, both on the default noise (GeneratorNoise reseeds at each
    epoch): the same parameters and the same losses of epochs 4-6, bit for
    bit on the CPU. The flow's dead logvar head, which Adam never steps,
    resumes too."""
    _, tds = _datasets()
    _, tc = _cfgs(vae_type, epoch=6, **extra)
    straight, h_straight = ttrain.train(tds, tc, str(tmp_path / "a"),
                                        device="cpu")
    ttrain.train(tds, tc.replace(epoch=3), str(tmp_path / "b"),
                 device="cpu", checkpoint_every=3)
    resumed, h_resumed = ttrain.train(tds, tc, str(tmp_path / "b"),
                                      device="cpu", checkpoint_every=3,
                                      resume=True)
    assert h_resumed == h_straight[3:]
    a, b = tckpt.flatten(straight), tckpt.flatten(resumed)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    saved = torch.load(tckpt.checkpoint_path(tc, str(tmp_path / "b"))
                       + ".resume.pt", weights_only=False)
    assert int(saved["epoch"]) == 6


@pytest.mark.parametrize("vae_type,extra", [
    ("reg_vae1", {}), ("reg_flow1", {"flow_actnorm": True, "hid_dim": 16})])
def test_jax_resume_file_resumed_by_the_port_reproduces_jax(tmp_path,
                                                            vae_type, extra):
    """JAX trains 3 epochs with checkpoint_every=3 (reg_flow1 with ActNorm:
    list keys in the file); the port resumes that file to 6 epochs under
    JAX's replayed key stream and lands where JAX's uninterrupted 6-epoch
    run lands: the losses of epochs 4-6 at HIST_RTOL, the parameters as
    FEW_APART says (3 epochs of 3 steps)."""
    jds, tds = _datasets()
    jc, tc = _cfgs(vae_type, epoch=6, **extra)
    root = str(tmp_path)
    assert tckpt.checkpoint_path(tc, root) == jckpt.checkpoint_path(jc, root)
    jtrain.train(jds, jc.replace(epoch=3), experiments_root=root,
                 checkpoint_every=3)
    # chunks of 3 epochs again: the same compiled program, the same keys
    want, want_hist = jtrain.train(jds, jc, save=False, checkpoint_every=3,
                                   experiments_root=str(tmp_path / "jax"))
    _, k_run = jax.random.split(jax.random.PRNGKey(jc.seed))
    got, got_hist = ttrain.train(tds, tc, root, device="cpu", resume=True,
                                 noise=JaxKeyStream(k_run, tc))
    assert len(got_hist) == 3
    np.testing.assert_allclose(got_hist, want_hist[3:], rtol=HIST_RTOL)
    _close_params(got, jckpt._flatten(want), steps=9)


@pytest.mark.parametrize("vae_type,extra", [
    ("reg_vae1", {}), ("reg_flow1", {"flow_actnorm": True, "hid_dim": 16})])
def test_port_resume_file_loads_in_jax(tmp_path, vae_type, extra):
    """A port-written resume file reads back in JAX `load_resume`, leaf for
    leaf: parameters, mu and nu equal, the count the number of steps (2
    epochs of 3), epochs done 2; and the port reads it back the same."""
    jds, tds = _datasets()
    jc, tc = _cfgs(vae_type, epoch=2, **extra)
    params, _ = ttrain.train(tds, tc, str(tmp_path), device="cpu",
                             checkpoint_every=2)
    path = tckpt.checkpoint_path(tc, str(tmp_path)) + ".resume.pt"
    tmpl = jget_model(jc).init(jax.random.PRNGKey(0), jc, jds.obs_dim)
    jp, jo, done = jckpt.load_resume(tmpl, optax.adam(1e-3).init(tmpl), path,
                                     tag=_tag(jc), max_epochs=2)
    assert done == 2 and int(jo[0].count) == 6
    for k, v in tckpt.flatten(params).items():
        np.testing.assert_array_equal(jckpt._flatten(jp)[k], v.numpy())
    tp, to, tdone = tckpt.load_resume(
        get_model(tc).init(torch.Generator().manual_seed(0), tc,
                           tds.obs_dim, device="cpu"), path, tag=_tag(tc))
    assert tdone == 2 and to.count == 6
    for name, moments in (("mu", jo[0].mu), ("nu", jo[0].nu)):
        want = jckpt._flatten(moments)
        for k, v in tckpt.flatten(getattr(to, name)).items():
            np.testing.assert_array_equal(want[k], v.numpy(), err_msg=k)
    # the flow's logvar head gets no gradient: zero moments in both
    if "flow" in vae_type:
        assert not np.any(jckpt._flatten(jo[0].mu)["decoder/logvar/layer0/w"])


def test_adam_state_round_trips_into_a_fresh_optimizer():
    """adam_state -> load_adam_state fills every leaf's step, exp_avg and
    exp_avg_sq on the parameters' device and the step in float32, so the
    next step of the refilled optimizer equals the original's."""
    _, tc = _cfgs("reg_vae1")
    params = get_model(tc).init(torch.Generator().manual_seed(0), tc, 6,
                                device="cpu")
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in tckpt.flatten(params).items()}
    opt = ttrain.make_optimizer(tckpt.unflatten(leaves))
    for _ in range(2):
        opt.zero_grad()
        sum((v ** 2).sum() for v in leaves.values()).backward()
        opt.step()
    state = tckpt.adam_state(opt, tckpt.unflatten(leaves))
    assert state.count == 2
    twin = {k: v.detach().clone().requires_grad_(True)
            for k, v in leaves.items()}
    opt2 = ttrain.make_optimizer(tckpt.unflatten(twin))
    tckpt.load_adam_state(opt2, tckpt.unflatten(twin), state)
    for v in twin.values():
        st = opt2.state[v]
        assert st["step"].dtype == torch.float32 and float(st["step"]) == 2
    for leaves_, opt_ in ((leaves, opt), (twin, opt2)):
        opt_.zero_grad()
        sum((v ** 2).sum() for v in leaves_.values()).backward()
        opt_.step()
    for k in leaves:
        assert torch.equal(leaves[k], twin[k]), k


def _jax_message(fn):
    with pytest.raises(RuntimeError) as exc:
        fn()
    return str(exc.value)


def test_final_boundary_is_written_when_epochs_are_not_a_multiple(tmp_path):
    """tests/test_utils_extra.py:323: epoch 5, checkpoint_every 2 -> the
    file says 5 epochs, in the port and read by JAX."""
    jds, tds = _datasets()
    jc, tc = _cfgs("vanilla_vae1", epoch=5, latent_dim=4)
    ttrain.train(tds, tc, str(tmp_path), device="cpu", checkpoint_every=2)
    path = tckpt.checkpoint_path(tc, str(tmp_path)) + ".resume.pt"
    tmpl = jget_model(jc).init(jax.random.PRNGKey(0), jc, jds.obs_dim)
    assert jckpt.load_resume(tmpl, optax.adam(1e-3).init(tmpl), path,
                             tag=_tag(jc))[2] == 5
    assert tckpt.load_resume(
        get_model(tc).init(torch.Generator().manual_seed(0), tc, 6,
                           device="cpu"), path, tag=_tag(tc))[2] == 5


def test_refusals_match_jax(tmp_path):
    """A tag that differs ('different sweep values'), a smaller budget
    ('already trained') and a layout that differs: the port refuses each
    with JAX's message, on the same file."""
    jc, tc = _cfgs("reg_vae1", latent_dim=4)
    jp = jget_model(jc).init(jax.random.PRNGKey(0), jc, 6)
    jo = optax.adam(1e-3).init(jp)
    tp = tckpt.params_from_jax(jckpt._flatten(jp), "cpu")
    path = str(tmp_path / "x.resume.pt")
    jckpt.save_resume(jp, jo, 3, path, tag="alpha:0.5,1.0:seed=0")
    assert tckpt.load_resume(tp, path, tag="alpha:0.5,1.0:seed=0")[2] == 3
    cases = [
        (dict(tag="alpha:1.0,2.0:seed=0"), "different sweep values"),
        (dict(tag="alpha:0.5,1.0:seed=0", max_epochs=2), "already trained")]
    for kw, words in cases:
        want = _jax_message(lambda: jckpt.load_resume(jp, jo, path, **kw))
        with pytest.raises(RuntimeError, match=words) as got:
            tckpt.load_resume(tp, path, **kw)
        assert str(got.value) == want
    # another model's template: the layout does not match
    jc2, tc2 = _cfgs("vanilla_EDDI1", latent_dim=4)
    jp2 = jget_model(jc2).init(jax.random.PRNGKey(0), jc2, 6)
    want = _jax_message(lambda: jckpt.load_resume(
        jp2, optax.adam(1e-3).init(jp2), path, tag="alpha:0.5,1.0:seed=0"))
    with pytest.raises(RuntimeError, match="layout does not match") as got:
        tckpt.load_resume(tckpt.params_from_jax(jckpt._flatten(jp2), "cpu"),
                          path, tag="alpha:0.5,1.0:seed=0")
    assert str(got.value) == want


def test_train_refuses_a_smaller_budget_a_changed_seed_or_batch(tmp_path):
    """tests/test_utils_extra.py:366 and :385 through the port's train: a
    finished 6-epoch run resumed at 4 epochs refuses, at 6 it republishes
    without training; a changed seed or batch size refuses."""
    _, tds = _datasets()
    _, tc = _cfgs("vanilla_vae1", epoch=6, latent_dim=4)
    root = str(tmp_path)
    ttrain.train(tds, tc, root, device="cpu", checkpoint_every=3)
    with pytest.raises(RuntimeError, match="already trained"):
        ttrain.train(tds, tc.replace(epoch=4), root, device="cpu",
                     resume=True)
    assert ttrain.train(tds, tc, root, device="cpu", resume=True)[1] == []
    for changed in (dict(seed=1), dict(batch_size=16)):
        with pytest.raises(RuntimeError, match="different sweep values"):
            ttrain.train(tds, tc.replace(**changed), root, device="cpu",
                         resume=True)


# ---------------------------------------------------------------------------
# early stopping
# ---------------------------------------------------------------------------


class JaxValKeys:
    """The JAX validation objective's draws (engine/train.py:223-248, 298):
    split(fold_in(k_run, 0x5A11D)) into (k_mask, k_model), the masks from
    k_mask as a training step's, the model's noise from k_model."""

    def __init__(self, k_run, cfg):
        self.k_mask, self.k_model = jax.random.split(
            jax.random.fold_in(k_run, 0x5A11D))
        self.cfg = cfg

    def __call__(self, kind, epoch, step, shape):
        assert (epoch, step) == (ttrain.VAL_EPOCH, 0)
        if kind == "mask_p":
            return _t(jax.random.uniform(self.k_mask, shape))
        if kind == "drop":
            return _t(jnp.stack([jax.random.uniform(k, shape[1:])
                                 for k in jax.random.split(self.k_mask)]))
        return model_noise(self.k_model, self.cfg, kind, shape)


def _recording(cls):
    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.losses = []

        def update(self, val_loss, params):
            self.losses.append(val_loss)
            return super().update(val_loss, params)

    return Recording


@pytest.mark.parametrize("vae_type", ["reg_vae1", "vanilla_vae1"])
def test_early_stopping_stops_where_jax_stops_with_jax_best_params(vae_type):
    """patience 1, chunk_epochs 2, up to 40 epochs, validating on a 10-row
    test split: JAX stops at epoch 4 (its second check is worse than its
    first). Each check's loss is first asserted to lie clear of the best
    so far (the stop decision cannot flip on rounding); then the port,
    under the replayed training and validation keys, checks the same
    losses at HIST_RTOL, stops at the same epoch and returns the first
    check's parameters (2 epochs of 3 steps), as JAX does."""
    jds, tds = _datasets(n_test=10)
    jc, tc = _cfgs(vae_type, epoch=40)
    jstop = _recording(jes.EarlyStopping)(patience=1)
    want, want_hist = jtrain.train(jds, jc, save=False, chunk_epochs=2,
                                   early_stopping=jstop)
    assert len(want_hist) == 4 < jc.epoch
    best = np.minimum.accumulate(jstop.losses)[:-1]
    gaps = np.asarray(jstop.losses[1:]) - best
    assert np.all(np.abs(gaps) > 1e-3 * np.abs(best)), gaps
    k_init, k_run = jax.random.split(jax.random.PRNGKey(jc.seed))
    init = jget_model(jc).init(k_init, jc, jds.obs_dim)
    tstop = _recording(tes.EarlyStopping)(patience=1)
    got, got_hist = ttrain.train(tds, tc, save=False, device="cpu",
                                 params=tckpt.params_from_jax(
                                     jckpt._flatten(init), "cpu"),
                                 chunk_epochs=2, early_stopping=tstop,
                                 noise=JaxKeyStream(k_run, tc),
                                 val_noise=JaxValKeys(k_run, tc))
    assert len(got_hist) == len(want_hist)
    np.testing.assert_allclose(got_hist, want_hist, rtol=HIST_RTOL)
    np.testing.assert_allclose(tstop.losses, jstop.losses, rtol=HIST_RTOL)
    assert tstop.early_stop and tstop.best_loss == tstop.losses[0]
    _close_params(got, jckpt._flatten(jstop.best_params), steps=6)


def test_validation_objective_does_not_depend_on_the_epoch():
    """tests/test_engine.py:227 for the port: ml_reg anneals by epoch, but
    the objective is evaluated at cfg.epoch with its draws fixed, so two
    checks of the same parameters agree exactly; another cfg.epoch gives
    another objective. Under JAX's validation keys it equals JAX's
    `_build_val_fn` at 1e-5."""
    jds, tds = _datasets()
    jc, tc = _cfgs("reg_vae1", reg_type="ml_reg", epoch=500)
    jparams = jget_model(jc).init(jax.random.PRNGKey(0), jc, 6)
    params = tckpt.params_from_jax(jckpt._flatten(jparams), "cpu")
    x, m = tds.train.x, tds.train.mask
    k_run = jax.random.PRNGKey(3)
    val = ttrain._build_val_fn(tc, get_model(tc), x, m, JaxValKeys(k_run, tc))
    v1 = val(params)
    assert val(params) == v1
    val2 = ttrain._build_val_fn(tc.replace(epoch=2500), get_model(tc), x, m,
                                JaxValKeys(k_run, tc))
    assert val2(params) != v1
    want = float(jtrain._build_val_fn(jc, jget_model(jc), jds.train.x,
                                      jds.train.mask)(
        jparams, jax.random.fold_in(k_run, 0x5A11D)))
    np.testing.assert_allclose(v1, want, rtol=1e-5)


def test_checkpoint_every_does_not_move_the_validation_cadence(tmp_path):
    """tests/test_utils_extra.py:437 for the port: checkpoint_every=1 with
    early stopping at chunk_epochs 4 validates at the same epochs, stops
    at the same epoch and gives the same parameters, bit for bit (the
    port's eager loop has no chunk programs to reassociate)."""
    _, tds = _datasets()
    _, tc = _cfgs("vanilla_vae1", epoch=8, latent_dim=4)
    runs = []
    for ck in (None, 1):
        stop = _recording(tes.EarlyStopping)(patience=1)
        params, hist = ttrain.train(tds, tc, str(tmp_path / str(ck)),
                                    device="cpu", chunk_epochs=4,
                                    checkpoint_every=ck, save=False,
                                    early_stopping=stop)
        runs.append((tckpt.flatten(params), hist, stop.losses))
    (p1, h1, v1), (p2, h2, v2) = runs
    assert h1 == h2 and v1 == v2 and len(v1) == 2
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k


def test_stored_best_parameters_survive_further_training():
    """Mutation check: EarlyStopping keeps a copy, so training on after the
    best check (Adam updating the leaves in place) leaves the stored best
    as it was, and a worse check does not replace it."""
    _, tc = _cfgs("reg_vae1")
    leaves = {k: v.requires_grad_(True) for k, v in tckpt.flatten(
        get_model(tc).init(torch.Generator().manual_seed(0), tc, 6,
                           device="cpu")).items()}
    params = tckpt.unflatten(leaves)
    snapshot = {k: v.detach().clone() for k, v in leaves.items()}
    stop = tes.EarlyStopping(patience=2)
    assert not stop.update(1.0, params)
    opt = ttrain.make_optimizer(params)
    opt.zero_grad()
    sum((v ** 2).sum() for v in leaves.values()).backward()
    opt.step()
    assert not stop.update(2.0, params)
    best = tckpt.flatten(stop.best_params)
    moved = [k for k in leaves if not torch.equal(leaves[k], snapshot[k])]
    assert moved
    for k, v in snapshot.items():
        assert torch.equal(best[k], v), k
        assert not best[k].requires_grad

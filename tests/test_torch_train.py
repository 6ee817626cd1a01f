"""The port's training path against the JAX package: `gauss.train_loss` with
torch Adam reproduces the two-step goldens of tests/test_golden.py from
JAX-initialised parameters and JAX-drawn noise; the EDDI two-mask path at
MNIST widths matches JAX's two steps live; `engine/train.train` fed a noise
source that replays the JAX trainer's key stream reproduces JAX `train`; and
a checkpoint the port saves loads in the JAX package."""

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
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.data import loaders as tloaders
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.engine import train as ttrain
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.ops import _kernel

#: tests/test_golden.py's pinned pairs and tolerance, for the gauss families
GOLDEN = {
    "reg_vae1": ("reg_vae1", {}, [13.596199, 13.687790]),
    "reg_vae1_ml_reg": ("reg_vae1", {"reg_type": "ml_reg"},
                        [8.340076, 8.197827]),
    "vanilla_vae1": ("vanilla_vae1", {}, [8.337935, 8.193361]),
    "vanilla_EDDI1": ("vanilla_EDDI1", {}, [8.306475, 8.161387]),
}
GOLDEN_RTOL = 2e-4


def _t(a):
    return torch.tensor(np.asarray(a))


def _trainable(jparams):
    return tckpt.unflatten({
        k: _t(v).requires_grad_(True)
        for k, v in jckpt._flatten(jparams).items()})


def _step_noise(key, cfg, B):
    """The noise JAX's gauss.train_loss draws from `key` (gauss.py:163, 185,
    196, 215; ops/math.reparameterize for the vanilla forward)."""
    kq, _kp, kz = jax.random.split(key, 3)
    L = cfg.latent_dim
    if not cfg.info.regularized:
        return _t(jax.random.normal(kq, (B, L))), None
    # the dense path draws [2B, L]; its row-major order is the [2, B, L] one
    eps = _t(jax.random.normal(kq, (2, B, L)))
    eps_z = (_t(jax.random.normal(kz, (B, L)))
             if cfg.reg_type == "ml_reg" else None)
    return eps, eps_z


def _batch(obs_dim, B):
    """tests/test_golden.py's inputs."""
    x = jax.random.uniform(jax.random.PRNGKey(12), (B, obs_dim))
    mask = (jax.random.uniform(jax.random.PRNGKey(13), (B, obs_dim)) < 0.7
            ).astype(jnp.float32)
    mask_p = mask * (jax.random.uniform(jax.random.PRNGKey(14), (B, obs_dim))
                     < 0.7).astype(jnp.float32)
    return x, mask, mask_p


def _port_two_steps(jc, tc, obs_dim, B):
    """tests/test_golden.py's two steps, through the port."""
    params = _trainable(jget_model(jc).init(jax.random.PRNGKey(11), jc,
                                            obs_dim))
    x, mask, mask_p = map(_t, _batch(obs_dim, B))
    opt = ttrain.make_optimizer(params)
    model = get_model(tc)
    losses = []
    for i in range(2):
        eps, eps_z = _step_noise(jax.random.PRNGKey(20 + i), tc, B)
        opt.zero_grad()
        loss, _ = model.train_loss(params, x, mask, mask_p, eps, float(i + 1),
                                   tc, eps_z=eps_z)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return np.array(losses)


def _jax_two_steps(jc, obs_dim, B):
    model = jget_model(jc)
    params = model.init(jax.random.PRNGKey(11), jc, obs_dim)
    x, mask, mask_p = _batch(obs_dim, B)
    tx = optax.adam(1e-3)
    opt = tx.init(params)

    @jax.jit
    def steps(params, opt):
        losses = []
        for i in range(2):
            loss, g = jax.value_and_grad(lambda p: model.train_loss(
                p, x, mask, mask_p, jax.random.PRNGKey(20 + i),
                jnp.float32(i + 1), jc)[0])(params)
            u, opt = tx.update(g, opt, params)
            params = optax.apply_updates(params, u)
            losses.append(loss)
        return jnp.stack(losses)

    return np.asarray(steps(params, opt))


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_port_reproduces_the_golden_two_steps(name):
    vae_type, kw, want = GOLDEN[name]
    jc = jcfg.RunConfig(vae_type=vae_type, latent_dim=4, train_k=3, **kw)
    tc = tcfg.RunConfig(vae_type=vae_type, latent_dim=4, **kw)
    got = _port_two_steps(jc, tc, obs_dim=6, B=16)
    np.testing.assert_allclose(got, want, rtol=GOLDEN_RTOL)
    assert got[1] != got[0]


def test_reg_eddi_two_mask_path_matches_jax_live_at_mnist_widths():
    """reg_EDDI1 with data_type='mnist' (trunk 500-500-200, decoder
    200-500-500) at obs_dim 20: the two-mask encoder, the posterior tail and
    kl_reg, two steps."""
    kw = dict(vae_type="reg_EDDI1", data_type="mnist")
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    got = _port_two_steps(jc, tc, obs_dim=20, B=16)
    want = _jax_two_steps(jc, obs_dim=20, B=16)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def model_noise(k_model, cfg, kind, shape):
    """The draw of noise `kind` (ModelDef.train_noise) that the JAX model
    makes from its key `k_model`, which follows the family: gauss splits it
    in three, (kq, kp, kz), and draws eps [2, B, L] or [B, L] from kq
    (gauss.py:163, 185, 196, 215) and eps_z from kz; the flow splits it in
    two, (kq, kp), and draws [B, L] from each (flow_vae.py:96,
    nn/flow.py:185); MIWAE splits it in two and draws [B, K, L] from each
    (miwae.py:61-69, 102); notMIWAE splits it in three, (kq, kp, ks), draws
    [B, K, L] from kq and kp and the 'sampled_mask' uniforms [B, D] from ks
    (notmiwae.py:69-78, 142, 156-158; bernoulli(ks, p) is
    uniform(ks, p.shape) < p). A regularized type stacks its q and p
    draws, [2, ...], except gauss, which draws [2, B, L] in one."""
    family = get_model(cfg).name
    keys = jax.random.split(k_model, 3 if family in ("gauss", "notmiwae")
                            else 2)
    if kind == "eps_z":
        assert family == "gauss"
        return _t(jax.random.normal(keys[2], shape))
    if kind == "mask_s":
        assert family == "notmiwae"
        return _t(jax.random.uniform(keys[2], shape))
    assert kind == "eps", kind
    if family == "gauss" or not cfg.info.regularized:
        return _t(jax.random.normal(keys[0], shape))
    return _t(jnp.stack([jax.random.normal(k, shape[1:])
                         for k in keys[:2]]))


class JaxKeyStream:
    """Replays the JAX trainer's key stream as a port noise source:
    engine/train.py:150-176 (per-epoch fold_in, permutation, per-step
    fold_in and split into (k_mask, k_model)), then the masks from k_mask
    (ops/masks.py:28-29 for mask_p; :38-40 for the drop mask, two uniforms
    from split(k_mask)) and the model's noise from k_model (`model_noise`)."""

    def __init__(self, k_run, cfg):
        self.k_run = k_run
        self.cfg = cfg

    def __call__(self, kind, epoch, step, shape):
        kperm, kstep = jax.random.split(jax.random.fold_in(self.k_run, epoch))
        if kind == "perm":
            return _t(jax.random.permutation(kperm, shape[0])).long()
        k_mask, k_model = jax.random.split(jax.random.fold_in(kstep, step))
        if kind == "mask_p":
            return _t(jax.random.uniform(k_mask, shape))
        if kind == "drop":
            return _t(jnp.stack([jax.random.uniform(k, shape[1:])
                                 for k in jax.random.split(k_mask)]))
        return model_noise(k_model, self.cfg, kind, shape)


def _tiny_datasets(n, obs_dim, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, obs_dim)).astype(np.float32)
    mask = (rng.random((n, obs_dim)) < 0.7).astype(np.float32)
    jds = jloaders.Dataset(train=jloaders.Split(jnp.asarray(x),
                                                jnp.asarray(mask), "train"),
                           test=None, obs_dim=obs_dim)
    tds = tloaders.Dataset(train=tloaders.Split(torch.from_numpy(x),
                                                torch.from_numpy(mask),
                                                "train"),
                           test=None, obs_dim=obs_dim)
    return jds, tds


#: Final parameters: after the same few Adam steps they agree to float32
#: rounding (measured: at most 8.4e-7 apart) except where a gradient
#: component is itself at rounding level (near zero); Adam divides such a
#: component by its own magnitude, so rounding in another summation order can
#: move that weight by up to the learning rate per step in either direction.
#: Bound: 2 * lr * steps on any weight, and at most one weight in a thousand
#: more than 1e-5 apart.
def train_against_jax(vae_type, reg_type="kl_reg", **extra):
    """JAX `train` and the port's `train` under JaxKeyStream from the same
    JAX-initialised parameters, on 20 rows of 6 features at batch 8 (3
    steps an epoch, 4 rows wrap-padded), 2 epochs, held as described
    above."""
    kw = dict(vae_type=vae_type, reg_type=reg_type, epoch=2, batch_size=8,
              seed=3, **extra)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    n, obs_dim = 20, 6
    jds, tds = _tiny_datasets(n, obs_dim, seed=1)
    want_params, want_hist = jtrain.train(jds, jc, save=False)
    k_init, k_run = jax.random.split(jax.random.PRNGKey(jc.seed))
    init = jget_model(jc).init(k_init, jc, obs_dim)
    got_params, got_hist = ttrain.train(
        tds, tc, save=False, device="cpu",
        noise=JaxKeyStream(k_run, tc),
        params=tckpt.params_from_jax(jckpt._flatten(init), "cpu"))
    assert len(got_hist) == len(want_hist) == 2
    np.testing.assert_allclose(got_hist, want_hist, rtol=1e-4)
    steps = 2 * 3
    want_flat = jckpt._flatten(want_params)
    got_flat = tckpt.flatten(got_params)
    assert sorted(got_flat) == sorted(want_flat)
    diffs = np.concatenate([
        np.abs(got_flat[k].numpy() - want_flat[k]).ravel() for k in got_flat])
    assert diffs.max() <= 2 * ttrain.LEARNING_RATE * steps, diffs.max()
    assert np.mean(diffs > 1e-5) <= 1e-3, np.sort(diffs)[-10:]
    return got_params


@pytest.mark.parametrize("vae_type,reg_type", [
    ("reg_vae1", "kl_reg"), ("reg_EDDI1", "ml_reg"),
    ("reg_vae1_mask_augm", "kl_reg"),
    # the EDDI drop mask: two uniforms a cell from split(k_mask)
    ("vanilla_vae1_with_drop", "kl_reg"),
    ("vanilla_EDDI1_with_drop", "kl_reg"),
    ("vanilla_vae1_with_drop_mask_augm", "kl_reg")])
def test_train_reproduces_jax_train_under_the_replayed_key_stream(
        vae_type, reg_type):
    train_against_jax(vae_type, reg_type)


def test_port_checkpoint_loads_in_jax(tmp_path):
    kw = dict(vae_type="reg_EDDI1", data_type="wine", epoch=1, batch_size=8)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    jds, tds = _tiny_datasets(12, 5, seed=2)
    params, hist = ttrain.train(tds, tc, experiments_root=str(tmp_path),
                                device="cpu")
    assert len(hist) == 1 and np.isfinite(hist[0])
    path = tckpt.checkpoint_path(tc, str(tmp_path))
    assert path == jckpt.checkpoint_path(jc, str(tmp_path))
    loaded = jckpt._flatten(
        jtrain.load_trained(jds, jc, experiments_root=str(tmp_path)))
    got = tckpt.flatten(params)
    assert sorted(loaded) == sorted(got)
    for k, v in got.items():
        np.testing.assert_array_equal(loaded[k], v.numpy(), err_msg=k)
    back = tckpt.flatten(ttrain.load_trained(tds, tc, str(tmp_path),
                                             device="cpu"))
    for k, v in got.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_cpu_training_counts_no_kernel_launch_and_cuda_needs_a_card():
    tc = tcfg.RunConfig(vae_type="reg_EDDI1", epoch=1, batch_size=4)
    _, tds = _tiny_datasets(6, 5, seed=4)
    before = _kernel.launches.copy()
    _, hist = ttrain.train(tds, tc, save=False, device="cpu")
    assert np.isfinite(hist).all()
    assert _kernel.launches == before
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train(tds, tc, save=False)

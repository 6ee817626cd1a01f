"""Training traffic: one call of the program's `engine/train.train` over a
table's training rows, cut by the window.

`train` runs epoch after epoch: a permutation of the n training rows,
wrap-padded to whole batches of `batch_size` rows, the program's step on
each batch with one Adam over the trainable leaves, and the epoch's summed
loss read to the host once. The driver makes one call with an epoch budget
no window reaches (`EPOCHS`), `save=False`, the harness's draws and the
weights made from the seed. Its `log_fn`, which `train` calls after each
epoch's host read, ends set-up after epoch 0 and `warmup_epochs` more by
opening the window, marks each epoch inside it, and ends the call once the
window's seconds have passed. Set-up and window are thus one optimizer and
one parameter state.

Correctness: the reference follows every step from the same weights, rows
and draws, from the first step through one epoch of the window drawn from
the seed among its first `sample_range` epochs (`train` keeps no state
outside its call, so the reference replays the run from its start).
Compared: the losses of the first `check_steps` steps, the first gradient
as Adam holds it after step 1, and the parameters' change after
`check_steps` steps; then the losses of the window's checked epoch and the
parameters' change at its end. The optimizer is read through torch's
global optimizer-step hooks, the steps' losses through `on_step`.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook

from harness import base, inputs, program
from counts import flops
from vae_posterior_consistency_tpu_torch.data.loaders import Dataset, Split
from vae_posterior_consistency_tpu_torch.engine import train as ptrain

BETA1 = 0.9

#: the call's epoch budget: the window ends the call long before
EPOCHS = 10**9


class WindowClosed(Exception):
    """Raised from `log_fn` to end the program's call at the window's
    close."""


class Noise:
    """The step's draws, from a generator on the device reseeded at each
    epoch from (seed, epoch); the draws of epochs up to `keep_to` are kept
    for the reference."""

    def __init__(self, seed, device, keep_to):
        self.seed, self.device, self.keep_to = seed, device, keep_to
        self.epoch = None
        self.kept = {}  # epoch -> [(kind, step, tensor)]

    def __call__(self, kind, epoch, step, shape):
        if epoch != self.epoch:
            self.gen = inputs.generator(self.seed, "train-noise", epoch,
                                        device=self.device)
            self.epoch = epoch
        if kind == "perm":
            t = torch.randperm(shape[0], generator=self.gen,
                               device=self.device)
        elif kind in ("mask_p", "drop", "mask_s"):
            t = torch.rand(shape, generator=self.gen, device=self.device)
        else:
            t = torch.randn(shape, generator=self.gen, device=self.device)
        if epoch <= self.keep_to:
            self.kept.setdefault(epoch, []).append((kind, step, t))
        return t


class Driver(base.Driver):
    opens_window = True
    steps = 0

    # -- set-up --------------------------------------------------------------

    def setup(self, seconds=None):
        cfg, dev, tr = self.cfg, self.device, self.traffic
        n_all, D = cfg["rows_train"] + cfg["rows_test"], cfg["obs_dim"]
        g = inputs.generator(self.seed, "data", device=dev)
        x = inputs.table(g, n_all, D, dev)
        mask = inputs.mcar(g, (n_all, D), cfg["missing_rate"], dev)
        rows = torch.randperm(n_all, generator=g, device=dev)[
            :cfg["rows_train"]]
        self.x, self.mask = x[rows].contiguous(), mask[rows].contiguous()
        self.data = Dataset(train=Split(self.x, self.mask, "train"),
                            test=None, obs_dim=D)
        self.p0 = inputs.weights(self.ref.param_specs(cfg),
                                 inputs.generator(self.seed, "weights",
                                                  device=dev), dev)
        self.rc = program.run_config(cfg, self.variant, epoch=EPOCHS)
        n = self.x.shape[0]
        self.bsz = min(cfg["batch_size"], n)
        self.per_epoch = math.ceil(n / self.bsz)
        if tr["check_steps"] > self.per_epoch:
            raise ValueError("check_steps must lie within epoch 0")
        # epochs 0 .. warm run in set-up; the window's epochs follow
        self.first_window_epoch = 1 + tr["warmup_epochs"]
        rng = np.random.default_rng(inputs.sub_seed(self.seed,
                                                    "train-sample"))
        self.check_epoch = self.first_window_epoch + int(
            rng.integers(0, tr["sample_range"]))
        self.noise = Noise(self.seed, dev, keep_to=self.check_epoch)

    # -- the window ----------------------------------------------------------

    def window(self, seconds, win):
        """The program's one call: set-up's epochs, then the window's."""
        check = self.traffic["check_steps"]
        self.losses = {}  # (epoch, step) -> loss on the device
        self.opt = None
        self.grad1 = self.p_after = self.p_window = None
        names = list(program.flat(program.nested(self.p0)))

        def pre_step(opt, args, kwargs):
            if self.opt is None:
                self.opt = opt
                if self.variant == "unchanged":
                    _freeze(opt)

        def on_step(epoch, s, loss):
            if epoch <= self.check_epoch:
                self.losses[epoch, s] = loss
            if epoch == 0 and s == 0:
                hook.remove()
                self.leaves = _leaves(self.opt, names, self.p0)
                self.grad1 = {k: _first_grad(self.opt, v)
                              for k, v in self.leaves.items()}
            if epoch == 0 and s == check - 1:
                self.p_after = _copy(self.leaves)
            if epoch == self.check_epoch and s == self.per_epoch - 1:
                self.p_window = _copy(self.leaves)

        def log_fn(epoch, loss_sum):
            # `epoch` counts the epochs done; the last one ran 0-based
            # epoch - 1
            if epoch == self.first_window_epoch:
                if self.variant == "unchanged_in_window":
                    _freeze(self.opt)
                win.open()
                self.end = win.t0 + seconds
                return
            if epoch < self.first_window_epoch:
                return
            if not math.isfinite(loss_sum):
                self.failed += self.per_epoch
            self.steps += self.per_epoch
            win.mark(self.steps)
            if time.perf_counter() >= self.end:
                win.close()
                raise WindowClosed

        hook = register_optimizer_step_pre_hook(pre_step)
        planted = (_half_batch_model(self.rc) if self.variant == "half_batch"
                   else contextlib.nullcontext())
        try:
            with planted:
                ptrain.train(self.data, self.rc, save=False,
                             device=self.device, noise=self.noise,
                             params=program.nested(self.p0),
                             on_step=on_step, log_fn=log_fn)
        except WindowClosed:
            pass
        finally:
            hook.remove()
        if not hasattr(win, "t1"):
            raise RuntimeError("the program's call ended before the window")

    def attempted(self):
        return self.steps

    def end_to_end(self, win) -> dict:
        return {"train_rows_per_s": self.steps * self.bsz / win.seconds}

    def context(self, win) -> dict:
        cfg, S, B = self.cfg, 2, self.bsz
        D, K, L = cfg["obs_dim"], cfg["K"], cfg["latent_dim"]
        n = self.steps
        return {
            "steps": n,
            "flops": flops.train_steps(cfg, n, B),
            "launches": [
                ("embed_pool_fwd", dict(S=S, B=B, D=D, K=K), n),
                ("embed_pool_bwd", dict(S=S, B=B, D=D, K=K, dx=False,
                                        dmasks=False), n),
                ("fused_posterior_fwd", dict(B=B, L=L), n),
                ("fused_posterior_bwd", dict(B=B, L=L), n),
            ],
        }

    def release(self):
        self.opt = self.leaves = None

    # -- correctness ---------------------------------------------------------

    def _batches(self, epoch):
        """The (x, mask, mask_p uniforms, eps) of each step of `epoch`, as
        the program drew them."""
        kept = self.noise.kept[epoch]
        perm = kept[0][2]
        pad = self.per_epoch * self.bsz - self.x.shape[0]
        if pad:
            perm = torch.cat([perm, perm[:pad]])
        draws = {}
        for kind, step, t in kept[1:]:
            draws.setdefault(step, {})[kind] = t
        out = []
        for s in range(self.per_epoch):
            rows = perm[s * self.bsz:(s + 1) * self.bsz]
            out.append((self.x[rows], self.mask[rows], draws[s]["mask_p"],
                        draws[s]["eps"]))
        return out

    def check(self) -> dict:
        """Reference: every step from the same weights, rows and draws
        through the window's checked epoch. Returns {number: value}."""
        check, k = self.traffic["check_steps"], self.check_epoch
        if self.p_window is None:
            # the window closed before its checked epoch ended
            return {name: math.inf for name in NUMBERS}
        batches = [b for e in range(k + 1) for b in self._batches(e)]
        first = batches[:check]
        window = slice(k * self.per_epoch, (k + 1) * self.per_epoch)
        ref = self.ref.train_steps(self.p0, self.cfg, first)
        ref_w = self.ref.train_steps(self.p0, self.cfg, batches)
        if self.variant == "tf32":
            with self.ref.precision("tf32"):
                losses, g1, p_after = self.ref.train_steps(self.p0, self.cfg,
                                                           first)
                losses_w, _, p_window = self.ref.train_steps(
                    self.p0, self.cfg, batches)
            losses_w = losses_w[window]
        else:
            losses = [float(self.losses[0, s]) for s in range(check)]
            losses_w = [float(self.losses[k, s])
                        for s in range(self.per_epoch)]
            g1, p_after, p_window = self.grad1, self.p_after, self.p_window
        out = compare_training(losses, g1, p_after, *ref, self.p0)
        out["window_loss_gap"] = loss_gap(losses_w, ref_w[0][window])
        out["window_change_gap"] = change_gap(p_window, ref_w[2], ref[1],
                                              self.p0)
        return out


NUMBERS = ("loss_gap", "grad_gap", "change_gap", "window_loss_gap",
           "window_change_gap")


def _leaves(opt, names, p0):
    """{name: leaf} of the optimizer's parameters, in the order the
    program hands them to Adam (its flattened parameters)."""
    params = [p for group in opt.param_groups for p in group["params"]]
    if [tuple(p.shape) for p in params] != [tuple(p0[k].shape)
                                            for k in names]:
        raise RuntimeError("the optimizer's leaves are not the parameters "
                           "in their flattened order")
    return dict(zip(names, params))


def _copy(leaves):
    return {k: v.detach().clone() for k, v in leaves.items()}


def _freeze(opt):
    """A fault: every later step leaves the parameters as they are."""
    for group in opt.param_groups:
        group["lr"] = 0.0


def _first_grad(opt, leaf):
    """The gradient Adam took at its first step, from its state:
    exp_avg = (1 - beta1) g. Zero where the step left no state."""
    state = opt.state.get(leaf, {})
    if "exp_avg" not in state:
        return torch.zeros_like(leaf).detach()
    return state["exp_avg"].detach().clone() / (1.0 - BETA1)


@contextlib.contextmanager
def _half_batch_model(rc):
    """A fault planted in the program: while it lasts, the trainer's model
    takes its loss over the first half of each batch's rows."""
    model = program.model(rc)
    train_loss = model.train_loss

    def loss(params, x, mask, mask_p, eps, epoch, cfg, **extra):
        h = x.shape[0] // 2
        return train_loss(params, x[:h], mask[:h], mask_p[:h],
                          eps[..., :h, :], epoch, cfg, **extra)

    faulty = program.replace(model, train_loss=loss)
    get_model = ptrain.get_model
    ptrain.get_model = lambda cfg: faulty
    try:
        yield
    finally:
        ptrain.get_model = get_model


def _norms(d):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def loss_gap(losses, ref_losses) -> float:
    """The largest relative gap of a step's loss."""
    if len(losses) != len(ref_losses):
        return math.inf
    return base.worst(*(abs(a - b) / abs(b)
                        for a, b in zip(losses, ref_losses)))


def change_gap(p_after, ref_p, ref_g, p0) -> float:
    """By the worst leaf, the gap of the norms of the parameters' change
    over the larger of the reference's and the median leaf's, over the
    leaves whose first reference gradient is at least a thousandth of the
    median leaf's (a gradient nought to rounding moves a leaf under Adam by
    round-off alone)."""
    rgn = _norms(ref_g)
    med_g = sorted(rgn.values())[len(rgn) // 2]
    keep = [k for k in rgn if rgn[k] >= 1e-3 * med_g]
    dn = _norms({k: p_after[k] - p0[k] for k in keep})
    rdn = _norms({k: ref_p[k] - p0[k] for k in keep})
    med_d = sorted(rdn.values())[len(rdn) // 2]
    return base.worst(*(abs(dn[k] - rdn[k]) / max(rdn[k], med_d)
                        for k in keep))


def compare_training(losses, g1, p_after, ref_losses, ref_g, ref_p, p0):
    """The three numbers of a training run's first steps:
    - loss_gap: the largest relative gap of a step's loss;
    - grad_gap: by the worst leaf, |‖g‖ - ‖g_ref‖| over the larger of
      ‖g_ref‖ and the median leaf's ‖g_ref‖, g the first gradient;
    - change_gap: `change_gap` of the parameters after the steps."""
    gn, rgn = _norms(g1), _norms(ref_g)
    med_g = sorted(rgn.values())[len(rgn) // 2]
    grad_gap = base.worst(*(abs(gn[k] - rgn[k]) / max(rgn[k], med_g)
                            for k in rgn))
    return {"loss_gap": loss_gap(losses, ref_losses), "grad_gap": grad_gap,
            "change_gap": change_gap(p_after, ref_p, ref_g, p0)}

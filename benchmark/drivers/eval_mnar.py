"""MNAR evaluation traffic: the program's `engine/evaluate.eval_vae_mnar`
over the whole matrix, calls back to back.

A call runs the traffic's M reps, each one `eval_step` over all the rows
at the configuration's valid_k importance samples a row, and reads the
mean RMSE over the holes to the host once. Each call draws from its own
generator, seeded from (seed, call). Set-up makes the table (the
configuration's `rows` x `obs_dim`, min-max scaled), its MNAR mask
(`mnar_mask`, the rule of the program's `data/generate._mnar_mask`) and
the weights from the seed, and runs one call of its own draws.

Correctness: `check_calls` calls drawn from the seed are scored again by
the reference from the same rows, mask, weights and recorded draws.
Compared: `rmse_gap`, the relative gap between the RMSE the call returned
and the reference's. A kept call must have drawn exactly one `eps` of
[rows, valid_k, latent_dim] a rep, so a call that skipped or repeated a
rep reads infinite.

Variants besides `run.py`'s (`tf32`: the reference with its products'
operands rounded to TF32 in the program's place; `bf16`: the program's
own bfloat16 path; `altered`: the returned RMSE times 1.001) are the
faults planted in the program for the harness's tests: `half_k`, each
`eval_step` sees only the first half of its samples; `no_missingness`,
log p(s|x) is left out of the weights.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from harness import base, inputs, program
from counts import flops_mnar
from vae_posterior_consistency_tpu_torch.engine import evaluate as pev

FAULTS = ("half_k", "no_missingness")


def mnar_mask(x, columns: int):
    """The float32 MNAR mask of table `x` (1 = observed): in the first
    `columns` features a cell above its column's mean is hidden, every
    other cell observed (the program's `data/generate._mnar_mask`, which
    takes the first D // 2 of the 13 wine columns before the loader drops
    the target)."""
    head = x[:, :columns]
    mask = torch.ones_like(x)
    mask[:, :columns] = (head <= head.mean(0)).to(x.dtype)
    return mask


class Noise:
    def __init__(self, seed, call, device, keep):
        self.gen = inputs.generator(seed, "eval-mnar-noise", call,
                                    device=device)
        self.device = device
        self.kept = [] if keep else None

    def __call__(self, kind, rep, step, shape):
        t = torch.randn(shape, generator=self.gen, device=self.device)
        if self.kept is not None:
            self.kept.append((kind, rep, step, t))
        return t


class Driver(base.Driver):
    calls = 0

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.cfg["M"] = self.traffic["M"]

    def setup(self, seconds=None):
        cfg, dev = self.cfg, self.device
        g = inputs.generator(self.seed, "data", device=dev)
        self.x = inputs.table(g, cfg["rows"], cfg["obs_dim"], dev)
        self.mask = mnar_mask(self.x, cfg["mnar_columns"])
        self.p0 = inputs.weights(self.ref.param_specs(cfg),
                                 inputs.generator(self.seed, "weights",
                                                  device=dev), dev)
        self.rc = program.run_config(cfg, self.variant,
                                     valid_k=cfg["valid_k"],
                                     not_miwae_type=cfg["not_miwae_type"])
        self.params = program.nested(self.p0)
        rng = np.random.default_rng(inputs.sub_seed(self.seed,
                                                    "eval-mnar-sample"))
        self.sample = sorted({0} | set(rng.integers(
            0, self.traffic["sample_range"],
            self.traffic["check_calls"]).tolist()))
        self.kept = {}
        self.call(-1)  # warm-up: the same shapes, its own draws

    def call(self, c):
        keep = c in self.sample
        noise = Noise(self.seed, c, self.device, keep=keep)
        imputed = [] if keep else None
        with _planted(self.variant), _capture(imputed):
            rmse = pev.eval_vae_mnar(self.x, self.mask, self.rc,
                                     params=self.params, save=False,
                                     noise=noise, device=self.device)
        if self.variant == "altered":
            rmse *= 1.001
        if not math.isfinite(rmse):
            self.failed += 1
        if keep:
            self.kept[c] = (rmse, noise.kept, imputed)

    def window(self, seconds, win):
        end = win.t0 + seconds
        while time.perf_counter() < end:
            self.call(self.calls)
            self.calls += 1
            win.mark(self.calls)
        win.close()

    def attempted(self):
        return self.calls

    def end_to_end(self, win) -> dict:
        return {"eval_rows_per_s": self.calls * self.cfg["rows"]
                * self.cfg["M"] / win.seconds}

    def context(self, win) -> dict:
        return {"calls": self.calls,
                "flops": self.calls * flops_mnar.eval_call(self.cfg)}

    def release(self):
        del self.params

    def check(self) -> dict:
        """`rmse_gap`: the largest relative gap between the RMSE a kept
        call returned and the reference's mean over its reps;
        `imputed_gap`: the largest gap of an imputed hole, over the kept
        calls' reps."""
        if not self.kept:
            raise RuntimeError("no call of the window was checked")
        cfg, rmse_gap, imputed_gap = self.cfg, 0.0, 0.0
        shape = (cfg["rows"], cfg["valid_k"], cfg["latent_dim"])
        hole = self.mask == 0
        for c in self.sample:
            if c not in self.kept:
                continue
            rmse, kept, imputed = self.kept[c]
            eps = [t for kind, _, _, t in kept if kind == "eps"]
            if len(eps) != cfg["M"] or len(imputed) != cfg["M"] or any(
                    tuple(t.shape) != shape for t in eps):
                return {"rmse_gap": math.inf, "imputed_gap": math.inf}
            ref = [self.ref.evaluate(self.p0, cfg, self.x, self.mask, e)
                   for e in eps]
            if self.variant == "tf32":
                with self.ref.precision("tf32"):
                    ctl = [self.ref.evaluate(self.p0, cfg, self.x, self.mask,
                                             e) for e in eps]
                rmse = _mean_rmse(ctl)
                imputed = [r["x_imputed"] for r in ctl]
            want = _mean_rmse(ref)
            rmse_gap = base.worst(rmse_gap, abs(rmse - want) / abs(want))
            for got, r in zip(imputed, ref):
                imputed_gap = base.worst(imputed_gap, float(
                    (got - r["x_imputed"])[hole].abs().max()))
        return {"rmse_gap": rmse_gap, "imputed_gap": imputed_gap}


def _mean_rmse(reps) -> float:
    return float(torch.stack([r["rmse"] for r in reps]).mean())


@contextlib.contextmanager
def _capture(into):
    """While it lasts, each rep's `x_imputed` is appended to `into` (where
    `into` is a list): the model's `eval_step` wrapped where
    `_mnar_rmse` calls it."""
    if into is None:
        yield
        return
    orig = pev._mnar_rmse

    def rmse(model, cfg, params, x, mask, mask_p, eps):
        def step(*args, **kw):
            out = model.eval_step(*args, **kw)
            into.append(out["x_imputed"])
            return out
        return orig(program.replace(model, eval_step=step), cfg, params, x,
                    mask, mask_p, eps)

    pev._mnar_rmse = rmse
    try:
        yield
    finally:
        pev._mnar_rmse = orig


@contextlib.contextmanager
def _planted(variant):
    """A fault planted in the program while it lasts: `half_k`, each rep's
    `eval_step` takes the first half of its samples; `no_missingness`,
    the notMIWAE model's weights leave out log p(s|x)."""
    if variant not in FAULTS:
        yield
        return
    if variant == "half_k":
        owner, name = pev, "_mnar_rmse"
        orig = pev._mnar_rmse

        def fault(model, cfg, params, x, mask, mask_p, eps):
            return orig(model, cfg, params, x, mask, mask_p,
                        eps[:, :eps.shape[1] // 2])
    else:
        from vae_posterior_consistency_tpu_torch.models import notmiwae
        owner, name = notmiwae, "_branch"
        orig = notmiwae._branch

        def fault(*args, **kw):
            return orig(*args, **{**kw, "with_s": False})
    setattr(owner, name, fault)
    try:
        yield
    finally:
        setattr(owner, name, orig)

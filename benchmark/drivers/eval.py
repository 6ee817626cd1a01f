"""Evaluation traffic: the program's `engine/evaluate.eval_vae` over both
splits of a table, calls back to back.

A call shuffles each split once (train, then test), wrap-pads it to whole
batches of `batch_size` rows and scores every batch at the traffic's M
reps (rmse on the missing cells, loss, negl, negl_imp), reading each
split's means to the host once. Each call draws from its own generator,
seeded from (seed, call). Set-up makes the splits (the configuration's
`rows_train` and `rows_test` rows and their MCAR mask) and the weights from
the seed, and runs one call of its own draws.

Correctness: `check_calls` calls drawn from the seed are scored again by
the reference from the same rows, permutations and draws, batch by batch
as the program batches them. Compared: what `eval_vae` returns, the
eight means (four metrics of two splits), by their largest relative gap. A kept call must have
drawn exactly one permutation a split and rep and one draw a batch, so a
call that skipped or repeated batches reads infinite.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from harness import base, inputs, program
from counts import flops
from vae_posterior_consistency_tpu_torch.data.loaders import Dataset, Split
from vae_posterior_consistency_tpu_torch.engine import evaluate as pev

METRICS = ("rmse", "loss", "negl", "negl_imp")


class Noise:
    def __init__(self, seed, call, device, keep):
        self.gen = inputs.generator(seed, "eval-noise", call, device=device)
        self.device = device
        self.kept = [] if keep else None

    def __call__(self, kind, rep, step, shape):
        if kind == "perm":
            t = torch.randperm(shape[0], generator=self.gen,
                               device=self.device)
        else:
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
        D, ntr, nte = cfg["obs_dim"], cfg["rows_train"], cfg["rows_test"]
        g = inputs.generator(self.seed, "data", device=dev)
        x = inputs.table(g, ntr + nte, D, dev)
        m = inputs.mcar(g, (ntr + nte, D), cfg["missing_rate"], dev)
        self.data = Dataset(train=Split(x[:ntr], m[:ntr], "train"),
                            test=Split(x[ntr:], m[ntr:], "test"), obs_dim=D)
        self.p0 = inputs.weights(self.ref.param_specs(cfg),
                                 inputs.generator(self.seed, "weights",
                                                  device=dev), dev)
        self.rc = program.run_config(cfg, self.variant)
        self.params = program.nested(self.p0)
        rng = np.random.default_rng(inputs.sub_seed(self.seed, "eval-sample"))
        self.sample = sorted({0} | set(rng.integers(
            0, self.traffic["sample_range"],
            self.traffic["check_calls"]).tolist()))
        self.kept = {}
        self.call(-1)  # warm-up: the same shapes, its own draws

    def call(self, c):
        keep = c in self.sample
        noise = Noise(self.seed, c, self.device, keep=keep)
        planted = (_half_batch() if self.variant == "half_batch"
                   else contextlib.nullcontext())
        with planted:
            res = pev.eval_vae(self.data, self.rc, params=self.params,
                               save=False, noise=noise, device=self.device)
        if self.variant == "altered":
            res["train"]["rmse"] *= 1.001
        if not all(np.isfinite(v) for s in res.values() for v in s.values()):
            self.failed += 1
        if keep:
            self.kept[c] = (res, noise.kept)

    def window(self, seconds, win):
        end = win.t0 + seconds
        while time.perf_counter() < end:
            self.call(self.calls)
            self.calls += 1
            win.mark(self.calls)
        win.close()

    def attempted(self):
        return self.calls

    def _rows(self):
        return self.data.train.n + self.data.test.n

    def _batches(self):
        b = self.cfg["batch_size"]
        return sum(-(-s.n // min(b, s.n)) for s in (self.data.train,
                                                   self.data.test))

    def end_to_end(self, win) -> dict:
        return {"eval_rows_per_s": self.calls * self._rows() * self.cfg["M"]
                / win.seconds}

    def context(self, win) -> dict:
        cfg = self.cfg
        D, K, B = cfg["obs_dim"], cfg["K"], cfg["batch_size"]
        nb = self._batches() * cfg["M"] * self.calls
        return {
            "calls": self.calls,
            "flops": flops.eval_rows(cfg, nb * B, calls=nb),
            "launches": [("embed_pool_fwd", dict(S=1, B=B, D=D, K=K), nb)],
        }

    def release(self):
        del self.params

    def check(self) -> dict:
        """`means_gap`: the largest relative gap of the eight means (four
        metrics of two splits) that a kept call returned."""
        worst = 0.0
        B, M = self.cfg["batch_size"], self.cfg["M"]
        if not self.kept:
            raise RuntimeError("no call of the window was checked")
        splits = (self.data.train, self.data.test)
        for c in self.sample:
            if c not in self.kept:
                continue
            res, kept = self.kept[c]
            expected = sum(M * (1 + -(-s.n // min(B, s.n))) for s in splits)
            if len(kept) != expected or set(res) != {s.stage for s in splits}:
                return {"means_gap": math.inf}
            draws = iter(kept)
            ref, ctl = [], []
            for split in splits:
                steps = -(-split.n // min(B, split.n))
                for m in range(M):
                    perm = next(draws)[3]
                    eps = torch.cat([next(draws)[3] for _ in range(steps)])
                    args = (self.p0, self.cfg, split.x, split.mask, perm,
                            eps, min(B, split.n))
                    ref.append(self.ref.evaluate_split(*args)[0])
                    if self.variant == "tf32":
                        with self.ref.precision("tf32"):
                            ctl.append(self.ref.evaluate_split(*args)[0])
            if self.variant == "tf32":
                res = self._ref_means(torch.cat(ctl))
            for stage, r in self._ref_means(torch.cat(ref)).items():
                worst = base.worst(worst, *(abs(res[stage][k] - r[k])
                                            / abs(r[k]) for k in METRICS))
        return {"means_gap": worst}

    def _ref_means(self, ref):
        """{stage: {metric: mean}} from the reference's per-batch rows,
        train's first, averaged as the program averages them."""
        B, M = self.cfg["batch_size"], self.cfg["M"]
        out, i = {}, 0
        for split in (self.data.train, self.data.test):
            steps = -(-split.n // min(B, split.n))
            block = ref[i:i + M * steps].reshape(M, steps, len(METRICS))
            out[split.stage] = dict(zip(METRICS,
                                        block.mean(1).mean(0).tolist()))
            i += M * steps
        return out


@contextlib.contextmanager
def _half_batch():
    """A fault planted in the program: while it lasts, each batch's
    statistics are taken over the first half of its rows."""
    batch_stats = pev._batch_stats

    def stats(model, cfg, params, x_b, m_b, mask_p, eps, w_b):
        h = x_b.shape[0] // 2
        return batch_stats(model, cfg, params, x_b[:h], m_b[:h],
                           None if mask_p is None else mask_p[:h], eps[:h],
                           w_b[:h])

    pev._batch_stats = stats
    try:
        yield
    finally:
        pev._batch_stats = batch_stats

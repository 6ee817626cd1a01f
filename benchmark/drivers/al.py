"""Active-learning traffic: EDDI selection episodes back to back on a
table's test rows, through the program's `engine/active_learning.
run_episode` (what the AL entry point runs for each repeat).

An episode starts from an empty mask and makes D-1 reveals a row; each of
its steps imputes the rows M times, scores every hidden candidate by its
information reward and reveals the best. Each episode draws from its own
generator, seeded from (seed, episode); its curve is read to the host at
its end, as the entry point reads each episode's artifacts. The weights
are made from the seed, the encoder's output layer scaled by
`encoder_head_scale`, so that the posterior moves with each revealed
feature as a trained model's does and the rewards' top-two gaps clear
float32 rounding (at the default init they are about 1e-4 with gaps of
2e-7).

Correctness: `check_episodes` episodes drawn from the seed are followed by
the reference step by step from the program's own masks (it reveals what
the program revealed): at each step its imputations from the same draws,
its rewards, and the predictive MSE after the program's reveal are
compared, and the program's reveal against the reference's best wherever
the reference's top two rewards lie further apart than `reveal_clearance`
(relative to the step's largest reward). The first step starts from the
empty mask, so the start is checked on its own.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import base, inputs, program
from counts import flops
from vae_posterior_consistency_tpu_torch.engine import active_learning as pal


class Noise:
    """An episode's draws, in the order the episode asks for them."""

    def __init__(self, seed, episode, device, keep):
        self.gen = inputs.generator(seed, "al-noise", episode, device=device)
        self.device = device
        self.kept = [] if keep else None

    def __call__(self, kind, repeat, step, shape):
        t = torch.randn(shape, generator=self.gen, device=self.device)
        if self.kept is not None:
            self.kept.append((kind, step, t))
        return t


class Driver(base.Driver):
    episodes = 0

    def setup(self, seconds=None):
        cfg, dev = self.cfg, self.device
        n_all, D = cfg["rows_train"] + cfg["rows_test"], cfg["obs_dim"]
        g = inputs.generator(self.seed, "data", device=dev)
        x = inputs.table(g, n_all, D, dev)
        inputs.mcar(g, (n_all, D), cfg["missing_rate"], dev)
        rows = torch.randperm(n_all, generator=g, device=dev)[
            cfg["rows_train"]:]
        self.x = x[rows].contiguous()
        specs = self.ref.param_specs(cfg)
        head = [k for k, _, _ in specs if k.startswith("encoder/pnp2/")
                and k.endswith("/w")][-1]
        self.p0 = inputs.weights(
            specs, inputs.generator(self.seed, "weights", device=dev), dev,
            scale={head: self.traffic["encoder_head_scale"]})
        self.rc = program.run_config(cfg, self.variant)
        self.model = program.model(self.rc)
        self.params = program.nested(self.p0)
        rng = np.random.default_rng(inputs.sub_seed(self.seed, "al-sample"))
        self.sample = sorted({0} | set(rng.integers(
            0, self.traffic["sample_range"],
            self.traffic["check_episodes"]).tolist()))
        self.kept = {}
        self.episode(-1)  # warm-up: the same shapes, its own draws

    def episode(self, e):
        noise = Noise(self.seed, e, self.device, keep=e in self.sample)
        if self.variant in ("unchanged", "altered"):
            orig, pal.al_step = pal.al_step, _fault(pal.al_step, self.variant)
        try:
            out = pal.run_episode(self.model, self.params, self.rc, self.x,
                                  noise, repeat=max(e, 0))
        finally:
            if self.variant in ("unchanged", "altered"):
                pal.al_step = orig
        curve = out["information_curve"][0].cpu()  # the episode's host read
        if not torch.isfinite(curve).all():
            self.failed += 1
        if e in self.sample:
            self.kept[e] = (out, noise.kept)

    def window(self, seconds, win):
        end = win.t0 + seconds
        while time.perf_counter() < end:
            self.episode(self.episodes)
            self.episodes += 1
            win.mark(self.episodes)
        win.close()

    def attempted(self):
        return self.episodes

    def end_to_end(self, win) -> dict:
        n, D = self.x.shape
        return {"al_reveals_per_s": self.episodes * n * (D - 1)
                / win.seconds}

    def context(self, win) -> dict:
        cfg = self.cfg
        n, D = self.x.shape
        M, K, U = cfg["M"], cfg["K"], D - 1
        # an episode's encoder calls: the empty-mask MSE's imputations,
        # then a step's imputations, q(x), the target's posterior, the two
        # candidate posteriors and the MSE's imputations
        per_step = [M * n, n, M * n, M * U * n, M * U * n, M * n]
        calls = [M * n] + per_step * U
        e = self.episodes
        sizes = {}
        for b in calls:
            sizes[b] = sizes.get(b, 0) + e
        decoded = (M * n) * (1 + 2 * U)
        work = (flops.encode_rows(cfg, sum(calls) * e, calls=len(calls) * e)
                + e * decoded * flops.decoder_row(cfg))
        return {
            "episodes": e, "flops": work,
            "launches": [("embed_pool_fwd", dict(S=1, B=b, D=D, K=K), c)
                         for b, c in sorted(sizes.items())],
        }

    def release(self):
        del self.params, self.model

    def check(self) -> dict:
        clear = self.traffic["reveal_clearance"]
        gaps = {"reward_gap": 0.0, "imputation_gap": 0.0, "curve_gap": 0.0,
                "reveal_mismatch": 0.0}
        if not set(self.sample) & set(self.kept):
            raise RuntimeError("no episode of the window was checked")
        for e in self.sample:
            if e not in self.kept:
                continue
            out, kept = self.kept[e]
            if self.variant == "tf32":
                with self.ref.precision("tf32"):
                    out = reference_episode(self.ref, self.p0, self.cfg,
                                            self.x, kept)
            for k, v in follow(self.ref, self.p0, self.cfg, self.x, kept,
                               out, clear).items():
                gaps[k] = base.worst(gaps[k], v)
        return gaps


def _draws(kept):
    by = {}
    for kind, step, t in kept:
        by[kind, step] = t
    return by


def reference_episode(ref, p, cfg, x, kept):
    """The reference's own episode from the same draws (the control put in
    the program's place): its reveals its own argmax."""
    d = _draws(kept)
    n, D = x.shape
    mask = torch.zeros_like(x)
    curve = [ref.al_mse(p, cfg, x, mask, d["init", 0])]
    R_hist, ims, actions = [], [], []
    for t in range(D - 1):
        im = ref.impute_samples(p, cfg, x, mask, d["im", t])
        R = ref.al_rewards(p, cfg, x, mask, im)
        a = torch.argmax(R, dim=1)
        mask = torch.maximum(mask, torch.nn.functional.one_hot(a, D).float())
        curve.append(ref.al_mse(p, cfg, x, mask, d["mse", t]))
        R_hist.append(R)
        ims.append(im)
        actions.append(a.float())
    return {"information_curve": torch.stack(curve)[None].expand(n, D),
            "action": torch.stack(actions).T, "R_hist": torch.stack(R_hist),
            "im": torch.stack(ims)}


def follow(ref, p, cfg, x, kept, out, clear):
    """The reference step by step from the program's masks: the largest
    reward gap (over the step's largest reward), imputation gap, relative
    curve gap, and the reveals that differ where the reference's top two
    rewards are `clear` apart."""
    d = _draws(kept)
    n, D = x.shape
    mask = torch.zeros_like(x)
    curve = out["information_curve"][0]
    r0 = ref.al_mse(p, cfg, x, mask, d["init", 0])
    g = {"reward_gap": 0.0, "imputation_gap": 0.0,
         "curve_gap": float(abs(curve[0] - r0) / r0), "reveal_mismatch": 0.0}
    for t in range(D - 1):
        im = ref.impute_samples(p, cfg, x, mask, d["im", t])
        R = ref.al_rewards(p, cfg, x, mask, im)
        hidden = mask[:, :D - 1] == 0
        scale = R[hidden].abs().max()
        g["reward_gap"] = base.worst(g["reward_gap"], float(
            ((out["R_hist"][t] - R).abs()[hidden]).max() / scale))
        g["imputation_gap"] = base.worst(g["imputation_gap"], float(
            (out["im"][t] - im).abs().max()))
        action = out["action"][:, t].long()
        top = torch.topk(R, 2, dim=1)
        cleared = (top.values[:, 0] - top.values[:, 1]) > clear * scale
        g["reveal_mismatch"] += float(((action != top.indices[:, 0])
                                       & cleared).sum())
        mask = torch.maximum(mask, torch.nn.functional.one_hot(
            action, D).float())
        mse = ref.al_mse(p, cfg, x, mask, d["mse", t])
        g["curve_gap"] = base.worst(g["curve_gap"],
                             float(abs(curve[t + 1] - mse) / mse))
    return g


def _fault(al_step, kind):
    """Faults of the harness's own tests: 'unchanged' returns the step's
    mask as it came in; 'altered' reveals each row's second-best
    candidate."""

    def step(model, params, cfg, x, mask, noise, repeat, t, row_weights=None):
        out = al_step(model, params, cfg, x, mask, noise, repeat, t,
                      row_weights)
        if kind == "unchanged":
            out["mask"] = mask
        else:
            second = torch.topk(out["R"], 2, dim=1).indices[:, 1]
            out["action"] = second.float()
            out["mask"] = mask + torch.nn.functional.one_hot(
                second, x.shape[1]).to(mask.dtype)
        return out

    return step

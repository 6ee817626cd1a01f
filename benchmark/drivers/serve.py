"""Serving traffic: an open loop of imputation requests to the program's
`engine/serve.ImputationServer`, served first come first served.

The mix (the traffic file): `rate_per_s` requests a second, Poisson
arrivals; a request holds 1 row with probability `single_row_share`, else
a log-uniform whole number of rows in [`rows_min`, `rows_max`]; its rows
are drawn from a pool of the configuration's test rows made from the seed,
with their MCAR mask. Every seed gets the same work (`schedule`): the seed
orders the sizes and the gaps between arrivals and picks the rows. A request is timed from when it was due to when `impute`
returned (it returns numpy, so the device work has finished); one that is
due while the server is busy waits.

Correctness: once the window has closed, a sample of the requests drawn
from the seed (`check_requests` of them, plus the first of each bucket and
the longest) is served again by the reference from the same rows, mask and
draws, and the imputed cells and row scores are compared.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from harness import base, inputs, program
from counts import flops
from vae_posterior_consistency_tpu_torch.engine import serve as pserve


class Noise:
    """A request's draws: a generator on the device seeded from (seed,
    request number); the sampled requests' draws are kept."""

    def __init__(self, seed, device, keep=()):
        self.seed, self.device = seed, device
        self.keep = set(keep)
        self.kept = {}
        self.gen = torch.Generator(device=device)

    def __call__(self, kind, ctr, shape):
        self.gen.manual_seed(inputs.sub_seed(self.seed, "serve", ctr))
        t = torch.randn(shape, generator=self.gen, device=self.device)
        if ctr in self.keep:
            self.kept[ctr] = t
        return t


def schedule(traffic, seconds, seed):
    """(sizes [N], arrival offsets [N] in seconds) of the window: N = rate
    x seconds requests in blocks of `block` requests, every block the same
    multiset of sizes (the mix's quantiles) and of gaps between arrivals
    (the exponential's quantiles at the rate), each block's order shuffled
    by the seed. So every seed and every stretch of the window offers the
    same load, and only the order of arrivals differs."""
    rate, block = traffic["rate_per_s"], traffic["block"]
    n_blocks = max(1, round(rate * seconds / block))
    q = (np.arange(block) + 0.5) / block
    n_single = round(block * traffic["single_row_share"])
    lo, hi = math.log(traffic["rows_min"]), math.log(traffic["rows_max"])
    qm = (np.arange(block - n_single) + 0.5) / max(1, block - n_single)
    sizes = np.concatenate([np.ones(n_single, np.int64),
                            np.rint(np.exp(lo + (hi - lo) * qm)).astype(
                                np.int64)])
    gaps = -np.log1p(-q) / rate
    rng = np.random.default_rng(inputs.sub_seed(seed, "schedule"))
    all_sizes = np.concatenate([rng.permutation(sizes)
                                for _ in range(n_blocks)])
    all_gaps = np.concatenate([rng.permutation(gaps)
                               for _ in range(n_blocks)])
    return all_sizes, np.cumsum(all_gaps) - all_gaps[0]


class Driver(base.Driver):
    def setup(self, seconds):
        cfg, tr, dev = self.cfg, self.traffic, self.device
        D = cfg["obs_dim"]
        P = cfg["rows_test"]
        g = inputs.generator(self.seed, "data", device=dev)
        pool_x = inputs.table(g, P, D, dev)
        pool_m = inputs.mcar(g, (P, D), cfg["missing_rate"], dev)
        self.pool_x = pool_x.cpu().numpy()
        self.pool_m = pool_m.cpu().numpy()
        self.p0 = inputs.weights(self.ref.param_specs(cfg),
                                 inputs.generator(self.seed, "weights",
                                                  device=dev), dev)
        self.sizes, self.due = schedule(tr, seconds, self.seed)
        N = len(self.sizes)
        rng = np.random.default_rng(inputs.sub_seed(self.seed, "rows"))
        self.offsets = rng.integers(0, P - self.sizes + 1)
        buckets = tuple(tr["buckets"])
        sample = set(rng.choice(N, size=min(N, tr["check_requests"]),
                                replace=False).tolist())
        bucket_of = [next(b for b in buckets if b >= s) for s in self.sizes]
        for b in buckets:
            first = next((i for i, x in enumerate(bucket_of) if x == b), None)
            if first is not None:
                sample.add(first)
        sample.add(int(np.argmax(self.sizes)))
        self.sample = sorted(sample)
        # the server numbers requests from 1; warmup() takes one a bucket
        self.ctr0 = len(buckets) + 1
        self.noise = Noise(self.seed, dev,
                           keep=[self.ctr0 + i for i in self.sample])
        rc = program.run_config(cfg, self.variant)
        self.server = pserve.ImputationServer(
            program.nested(self.p0), rc, D, buckets=buckets, device=dev,
            noise=self.noise)
        if self.variant == "altered":
            self.server.model = program.model(
                rc, eval_step=_altered(self.server.model.eval_step))
        self.server.warmup()
        self.bucket_of = bucket_of

    def window(self, seconds, win):
        N = len(self.sizes)
        self.latency = np.zeros(N)
        self.service = np.zeros(N)
        self.late = []
        self.answers = {}
        keep = set(self.sample)
        t0 = win.t0
        for i in range(N):
            due = t0 + self.due[i]
            now = time.perf_counter()
            if now < due:
                if due - now > 1e-3:
                    time.sleep(due - now - 1e-3)
                while time.perf_counter() < due:
                    pass
                self.late.append(time.perf_counter() - due)
            o, n = self.offsets[i], self.sizes[i]
            start = time.perf_counter()
            try:
                filled, score = self.server.impute(
                    self.pool_x[o:o + n], self.pool_m[o:o + n])
            except Exception:
                self.failed += 1
                filled = score = None
            done = time.perf_counter()
            win.mark(i + 1)
            self.latency[i] = done - due
            self.service[i] = done - start
            if i in keep:
                self.answers[i] = (filled, score)
        win.close()

    def attempted(self):
        return len(self.sizes)

    def end_to_end(self, win) -> dict:
        return {"serve_p95_ms": float(np.percentile(self.latency, 95)) * 1e3}

    def notes(self) -> list:
        late = np.array(self.late) * 1e3 if self.late else np.zeros(1)
        fifth = max(1, len(self.latency) // 5)
        head = np.median(self.latency[:fifth]) * 1e3
        tail = np.median(self.latency[-fifth:]) * 1e3
        return [f"serve: {len(self.sizes)} requests at "
                f"{self.traffic['rate_per_s']}/s, generator lateness p50 "
                f"{np.median(late):.4f} ms max {late.max():.4f} ms over "
                f"{len(self.late)} idle arrivals, latency p50 "
                f"{np.median(self.latency) * 1e3:.4f} ms p99 "
                f"{np.percentile(self.latency, 99) * 1e3:.4f} ms; backlog: "
                f"latency p50 of the first fifth {head:.4f} ms, of the "
                f"last fifth {tail:.4f} ms"]

    def context(self, win) -> dict:
        cfg = self.cfg
        D, K = cfg["obs_dim"], cfg["K"]
        counts = {}
        for b in self.bucket_of:
            counts[b] = counts.get(b, 0) + 1
        rows = sum(b * c for b, c in counts.items())
        return {
            "requests": len(self.sizes),
            "impute_ms": (self.service * 1e3).tolist(),
            "flops": flops.eval_rows(cfg, rows, calls=len(self.sizes)),
            "launches": [("embed_pool_fwd", dict(S=1, B=b, D=D, K=K), c)
                         for b, c in sorted(counts.items())],
        }

    def release(self):
        del self.server

    def check(self) -> dict:
        dev = self.device
        gaps_cell, gaps_score = [0.0], [0.0]
        for i in self.sample:
            filled, score = self.answers[i]
            if filled is None:
                continue
            o, n = self.offsets[i], self.sizes[i]
            x = torch.from_numpy(self.pool_x[o:o + n]).to(dev)
            m = torch.from_numpy(self.pool_m[o:o + n]).to(dev)
            eps = self.noise.kept[self.ctr0 + i][:n]
            ref_f, ref_s = self.ref.serve(self.p0, self.cfg, x, m, eps)
            if self.variant == "tf32":
                with self.ref.precision("tf32"):
                    filled, score = (t.cpu().numpy() for t in self.ref.serve(
                        self.p0, self.cfg, x, m, eps))
            ref_f, ref_s = ref_f.cpu().numpy(), ref_s.cpu().numpy()
            gaps_cell.append(float(np.abs(filled - ref_f).max()))
            gaps_score.append(float(np.max(np.abs(score - ref_s)
                                           / np.abs(ref_s))))
        return {"imputed_gap": base.worst(*gaps_cell),
                "score_gap": base.worst(*gaps_score)}


def _altered(eval_step):
    """A fault: every imputed value of a batch's first row moved by 0.01
    where it is produced."""

    def step(*args, **kw):
        out = dict(eval_step(*args, **kw))
        xi = out["x_imputed"].clone()
        xi[0] += 0.01
        out["x_imputed"] = xi
        return out

    return step

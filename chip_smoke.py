#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Run from the root of a checkout. It drives only the port
(vae_posterior_consistency_tpu_torch), never JAX, in these phases:

1. environment: the card's name and power limit, torch and CUDA versions,
   the number of cards visible; TF32 off for every comparison;
2. build: every kernel in vae_posterior_consistency_tpu_torch/csrc/ with
   nvcc (plain C interface, loaded with ctypes), all sources at once;
3. each kernel against its plain PyTorch version on the card, at the shapes
   the serving and training paths give it and beyond them (three masks, 64
   features): B2f (embed+pool forward), B2b (its backward, with and without
   the dmasks output) and B1 (the posterior tail); and each autograd
   Function's gradients against autograd through the plain forward;
4. serving: the trained MNIST reg_EDDI1 checkpoint in the repo (reference
   state_dict, mapped by the port) behind ImputationServer(device="cuda"),
   imputing the 179 MNIST test rows in requests of 1, 8, 64 and 179 rows.
   Observed cells must come back unchanged and every output finite; B2f's
   launch count must rise by one per request; a CPU server (the kernels'
   plain versions) fed the same noise must agree; the trained model must
   beat filling each missing cell with its column's observed mean;
5. one HTTP round trip to the server on a free port;
6. training, MNIST reg_EDDI1 / kl_reg at full width on the 1618 training
   rows, batch 64: (a) the first step's loss and gradients on the card
   against the CPU (plain versions) from the same parameters, batch and
   recorded noise; (b) engine/train.train for 3 epochs (78 steps), each of
   B1, B2f and B2b launched exactly once a step, every loss finite, the loss
   falling; (c) the saved checkpoint loaded back and served;
7. training, the flagship reg_vae1 / kl_reg on Data/wine split 1, batch 64,
   30 epochs: B1 once a step, the embed+pool kernels never, the loss falling;
8. timings with CUDA events and the host clock: B2f and B2b as the serving
   and training paths launch them (`EmbedPool.forward` on A and C [D, K],
   `EmbedPool.backward` for A and C only), the standalone `embed_pool_bwd`,
   one shape where the bytes and not the launch set the time (S=2,
   B=4096), and B1; each figure with the number of device operations one
   call makes, counted by torch.profiler.

It prints a JSON line of the kernels (launches on the MNIST training run,
launches per call, error against the plain version, times, bound), then, as
its last line,
{"ok": true, "device": {...}}. Without CUDA, outside a checkout, or when any
phase fails, it exits nonzero and prints no result. A watchdog ends the run
after 300 s. It writes nothing in the checkout but the kernels' build
directory; checkpoints go to a temporary directory.
"""

import faulthandler

faulthandler.dump_traceback_later(300, exit=True)

import contextlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
import urllib.request  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

REPO = Path(__file__).resolve().parent
SEED = 0
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s outside
#: the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
#: B2f and B1 against their plain versions: the sums (over d; over the B*L
#: cells) run in another order in the kernel
KERNEL_TOL = dict(rtol=1e-5, atol=1e-4)
#: B2b against its plain version: dx and dmasks sum K=10 terms, so float32
#: rounding in another order stays near 1e-6 of their size; dA and dC sum B
#: terms (each warp over its rows, then the warps in order), so the absolute
#: tolerance grows with B
BWD_RTOL = 1e-5
BWD_ATOL_PER_TERM = 1e-5
#: the card's server against the CPU server (plain versions), same noise.
#: Imputed cells: atol 1e-4. A row score sums 784 cells, and its running sum
#: is ~1e3 whatever the score (the constant terms alone are 784*log(sqrt(2pi))
#: and 0.5*log(0.02) per observed cell), so float32 rounding in another
#: summation order moves it by about 1e3 * 2**-24 * sqrt(784) ~ 2e-3 whatever
#: its value: atol 5e-3.
SERVE_ATOL = 1e-4
SERVE_SCORE_ATOL = 5e-3
#: the card's first training step against the CPU's, same parameters, batch
#: and noise. The loss sums 2 * 64 * 784 reconstruction cells and the KL
#: terms after 500-wide matmuls that cuBLAS and the CPU accumulate in other
#: orders; float32 rounding moves it by ~1e-6 relative: rtol 1e-4. Each
#: gradient leaf is a sum over the batch's rows of products through the same
#: layers; its rounding is ~1e-6 of its largest entry: atol 1e-4 * max|leaf|.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_REL = 1e-4
REQUEST_ROWS = (1, 8, 64, 179)
TIMING_RUNS = 100
MNIST_EPOCHS = 3
WINE_EPOCHS = 30
LATENT = 10


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)
    yield
    print(f"== {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def event_ms(fn, runs=TIMING_RUNS, per_run=10):
    """Median device time of one call of `fn`, from CUDA events around
    `per_run` back-to-back calls, `runs` times. A busy-wait kernel queued
    first keeps the host's launch cost out of the interval."""
    import torch

    times = []
    for _ in range(runs):
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def _bound(nbytes, ops):
    """Least time for a function on the card (ms): its bytes over the memory
    rate or its float32 operations over the float32 rate, whichever is
    larger, and which of the two it is."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def embed_pool_bound_ms(S, B, D, K):
    """B2f: reads x, masks, A, C and writes the output once; (3+2S)*B*D*K
    operations."""
    nbytes = 4 * (B * D + S * B * D + 2 * D * K + S * B * K)
    return _bound(nbytes, (3 + 2 * S) * B * D * K)


def embed_pool_bwd_bound_ms(S, B, D, K, dx=True, dmasks=True):
    """B2b: reads x, masks, A, C, g and writes dx and dmasks (each if asked),
    dA, dC once; (6+2S)*B*D*K operations for dA and dC (the affine
    recomputed, gsum, its gate, dA, dC), 2 more a cell for dx and 1+2S for
    dmasks: (9+4S) with all four."""
    nbytes = 4 * (B * D + S * B * D + 2 * D * K + S * B * K
                  + (B * D if dx else 0) + (S * B * D if dmasks else 0)
                  + 2 * D * K)
    ops = (6 + 2 * S + (2 if dx else 0) + (1 + 2 * S if dmasks else 0))
    return _bound(nbytes, ops * B * D * K)


def fused_posterior_bound_ms(B, L):
    """B1: reads six [B,L] inputs, writes z_q, z_p and three sums once;
    about 31 operations a cell (8 for the two samples, 7 for each KL to
    N(0,I), 9 for KL(q||p), counting an exponential as one)."""
    return _bound(4 * (8 * B * L + 3), 31 * B * L)


def device_ops(fn):
    """Device operations (kernels, copies, fills) one call of `fn` puts on
    the card, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(2):  # the larger of two counts: a trace may drop an event
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == DeviceType.CUDA
                          and not getattr(e, "is_user_annotation", False)))
    return max(counts)


def max_abs(a, b):
    return (a - b).abs().max().item()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this needs one CUDA card",
              file=sys.stderr)
        return 1
    if not (REPO / "vae_posterior_consistency_tpu_torch").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repo (no "
              "vae_posterior_consistency_tpu_torch/)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()

    with phase("environment"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
        print(card, flush=True)
        card = card.splitlines()[0]
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}, device 0: "
              f"{torch.cuda.get_device_name(0)}; cards visible: "
              f"{torch.cuda.device_count()}, cards used: 1", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from vae_posterior_consistency_tpu_torch.config import RunConfig
    from vae_posterior_consistency_tpu_torch.data import loaders
    from vae_posterior_consistency_tpu_torch.engine import checkpoint, serve
    from vae_posterior_consistency_tpu_torch.engine import train as trainer
    from vae_posterior_consistency_tpu_torch.models import get_model, layers
    from vae_posterior_consistency_tpu_torch.ops import _build
    from vae_posterior_consistency_tpu_torch.ops import fused_embed_pool as fep
    from vae_posterior_consistency_tpu_torch.ops import fused_posterior as fp

    def reset_counts():
        fep.embed_pool.launches = 0
        fep.embed_pool_bwd.launches = 0
        fp.fused_posterior.launches = 0

    def counts():
        return {"embed_pool_fwd": fep.embed_pool.launches,
                "embed_pool_bwd": fep.embed_pool_bwd.launches,
                "fused_posterior_fwd": fp.fused_posterior.launches}

    with phase("build"):
        t0 = time.perf_counter()
        libs, log = _build.build_all()
        build_s = time.perf_counter() - t0
        print(log, end="", flush=True)
        for stem, path in libs.items():
            print(f"built {stem}: {path.relative_to(REPO)}", flush=True)
        print(f"build time {build_s:.3f} s", flush=True)

    D, K = 784, 10
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(S, B, K=K):
        x = torch.rand(B, D, device="cuda", generator=gen)
        masks = (torch.rand(S, B, D, device="cuda", generator=gen)
                 < 0.7).float()
        A = torch.randn(D, K, device="cuda", generator=gen) * 0.3
        C = torch.randn(D, K, device="cuda", generator=gen) * 0.3
        return x, masks, A, C

    def stats(B, L):
        mq, mp, eq, ep = torch.randn(4, B, L, device="cuda", generator=gen)
        lq, lp = torch.rand(2, B, L, device="cuda", generator=gen) * 3 - 2
        return mq, lq, mp, lp, eq, ep

    max_err = {"embed_pool_fwd": 0.0, "embed_pool_bwd": 0.0,
               "fused_posterior_fwd": 0.0}
    with phase("kernels against their plain versions"):
        for S, B, k in [(1, 1, K), (1, 8, K), (1, 64, K), (1, 179, K),
                        (1, 512, K), (2, 64, K), (2, 4096, K), (3, 64, K),
                        (2, 64, 64)]:
            args = inputs(S, B, k)
            got = fep.embed_pool(*args)
            torch.cuda.synchronize()
            want = fep.embed_pool_reference(*args)
            err = max_abs(got, want)
            max_err["embed_pool_fwd"] = max(max_err["embed_pool_fwd"], err)
            torch.testing.assert_close(got, want, **KERNEL_TOL)
            print(f"B2f embed_pool S={S} B={B} D={D} K={k}: max abs diff "
                  f"{err:.3e}", flush=True)
        bwd_cases = [(S, B, K) for S in (1, 2) for B in (1, 7, 64, 179)]
        for S, B, k in bwd_cases + [(3, 64, K), (2, 64, 64)]:
            args = inputs(S, B, k)
            g = torch.randn(S, B, k, device="cuda", generator=gen)
            want = fep.embed_pool_bwd_reference(*args, g)
            for dmasks in (True, False):
                got = fep.embed_pool_bwd(*args, g, dmasks=dmasks)
                torch.cuda.synchronize()
                errs = []
                for i, name in enumerate(("dx", "dmasks", "dA", "dC")):
                    if name == "dmasks" and not dmasks:
                        if got[1] is not None:
                            raise AssertionError("dmasks=False gave dm")
                        continue
                    atol = BWD_ATOL_PER_TERM * (B if i >= 2 else k)
                    torch.testing.assert_close(got[i], want[i],
                                               rtol=BWD_RTOL, atol=atol)
                    errs.append(f"{name} {max_abs(got[i], want[i]):.3e}")
                    max_err["embed_pool_bwd"] = max(
                        max_err["embed_pool_bwd"],
                        max_abs(got[i], want[i]))
                print(f"B2b embed_pool_bwd S={S} B={B} D={D} K={k} "
                      f"dmasks={dmasks}: max abs diff "
                      f"{', '.join(errs)}", flush=True)
        args = inputs(2, 64)
        g = torch.randn(2, 64, K, device="cuda", generator=gen)
        for name, fn in (("B2f", lambda: [fep.embed_pool(*args)]),
                         ("B2b", lambda: fep.embed_pool_bwd(*args, g))):
            if not all(torch.equal(u, v) for u, v in zip(fn(), fn())):
                raise AssertionError(f"{name} gave other bits on a second "
                                     "call")
        print("B2f and B2b at S=2, B=64: the same bits on two calls",
              flush=True)
        for B, L in [(64, 10), (7, 3), (4096, 10)]:
            args = stats(B, L)
            got = fp.fused_posterior(*args)
            torch.cuda.synchronize()
            want = fp.fused_posterior_reference(*args)
            errs = []
            for name, u, v in zip(("z_q", "z_p", "KL_q", "KL_p", "KL_reg"),
                                  got, want):
                torch.testing.assert_close(u, v, **KERNEL_TOL)
                errs.append(f"{name} {max_abs(u, v):.3e}")
                max_err["fused_posterior_fwd"] = max(
                    max_err["fused_posterior_fwd"], max_abs(u, v))
            print(f"B1 fused_posterior [{B},{L}]: max abs diff "
                  f"{', '.join(errs)}", flush=True)

        # the autograd Functions against autograd through the plain forward
        args = stats(64, 10)
        cts = [*stats(64, 10)[:2], *torch.randn(3, device="cuda",
                                                generator=gen)]
        a = [t.clone().requires_grad_() for t in args]
        b = [t.clone().requires_grad_() for t in args]
        got = torch.autograd.grad(fp.fused_posterior(*a), a, cts)
        want = torch.autograd.grad(fp.fused_posterior_reference(*b), b, cts)
        for u, v in zip(got, want):
            torch.testing.assert_close(u, v, **KERNEL_TOL)
        print("FusedPosterior gradients (6 inputs) vs autograd of the plain "
              f"forward: max abs diff "
              f"{max(max_abs(u, v) for u, v in zip(got, want)):.3e}",
              flush=True)
        args = inputs(2, 64)
        g = torch.randn(2, 64, K, device="cuda", generator=gen)
        a = [t.clone().requires_grad_() for t in args]
        b = [t.clone().requires_grad_() for t in args]
        got = torch.autograd.grad(fep.embed_pool(*a), a, g)
        want = torch.autograd.grad(fep.embed_pool_reference(*b), b, g)
        errs = []
        for i, (name, u, v) in enumerate(zip(("dx", "dmasks", "dA", "dC"),
                                             got, want)):
            torch.testing.assert_close(
                u, v, rtol=BWD_RTOL,
                atol=BWD_ATOL_PER_TERM * (64 if i >= 2 else K))
            errs.append(f"{name} {max_abs(u, v):.3e}")
        print(f"EmbedPool gradients vs autograd of the plain forward: max abs "
              f"diff {', '.join(errs)}", flush=True)

    cfg = RunConfig(vae_type="reg_EDDI1", data_type="mnist", missing_rate=30,
                    seed=SEED)
    with phase("serving"):
        path = checkpoint.checkpoint_path(cfg, root=str(REPO / "experiments"))
        params = checkpoint.load_reference(path, cfg, 784, device="cuda")
        test = loaders.data_loader_mnist(str(REPO / "Data"), cfg.vae_type,
                                         cfg.missing_rate, 64,
                                         device="cpu").test
        data, mask = test.x.numpy(), test.mask.numpy()
        x = data * mask  # the server never sees the missing cells

        card_noise = serve.GeneratorNoise(cfg.seed + 9, "cuda")
        drawn = []

        def recording_noise(ctr, shape):
            eps = card_noise(ctr, shape)
            drawn.append(eps)
            return eps

        srv = serve.ImputationServer(params, cfg, 784, device="cuda",
                                     noise=recording_noise).warmup()
        drawn.clear()
        reset_counts()
        outs = [srv.impute(x[:n], mask[:n]) for n in REQUEST_ROWS]
        serve_counts = counts()
        print(f"launches while serving {len(REQUEST_ROWS)} requests: "
              f"{serve_counts}", flush=True)
        if serve_counts != {"embed_pool_fwd": len(REQUEST_ROWS),
                            "embed_pool_bwd": 0, "fused_posterior_fwd": 0}:
            raise AssertionError(f"serving {len(REQUEST_ROWS)} requests "
                                 f"launched {serve_counts}")

        replay = iter([e.cpu() for e in drawn])
        cpu_srv = serve.ImputationServer(params, cfg, 784, device="cpu",
                                         noise=lambda ctr, shape: next(replay))
        for n, (filled, score) in zip(REQUEST_ROWS, outs):
            if filled.shape != (n, 784) or score.shape != (n,):
                raise AssertionError(f"bad shapes {filled.shape} "
                                     f"{score.shape}")
            if not (np.isfinite(filled).all() and np.isfinite(score).all()):
                raise AssertionError(f"non-finite output for {n} rows")
            np.testing.assert_array_equal(filled * mask[:n], x[:n])
            c_filled, c_score = cpu_srv.impute(x[:n], mask[:n])
            np.testing.assert_allclose(filled, c_filled, rtol=0,
                                       atol=SERVE_ATOL)
            np.testing.assert_allclose(score, c_score, rtol=0,
                                       atol=SERVE_SCORE_ATOL)
            print(f"{n} rows: card vs CPU max abs diff imputed "
                  f"{np.abs(filled - c_filled).max():.3e}, row score "
                  f"{np.abs(score - c_score).max():.3e}", flush=True)
        hole = 1.0 - mask
        filled = outs[-1][0]
        rmse = float(np.sqrt((np.square(filled - data) * hole).sum()
                             / hole.sum()))
        col_mean = x.sum(0) / np.maximum(mask.sum(0), 1.0)
        rmse_mean = float(np.sqrt((np.square(col_mean - data) * hole).sum()
                                  / hole.sum()))
        print(f"RMSE on the {int(hole.sum())} missing cells of the 179 MNIST "
              f"test rows: {rmse:.6f} (column-mean fill: {rmse_mean:.6f})",
              flush=True)
        if not rmse < rmse_mean:
            raise AssertionError("the trained model does not beat the "
                                 "column-mean fill")

    with phase("http"):
        httpd = serve.make_http_server(srv, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        before = fep.embed_pool.launches
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{httpd.server_address[1]}/impute",
                data=json.dumps({"x": x[:2].tolist(),
                                 "mask": mask[:2].tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                body = json.loads(resp.read())
        finally:
            httpd.shutdown()
            httpd.server_close()
        thread.join(timeout=30)
        if thread.is_alive():
            raise AssertionError("the HTTP server thread did not stop")
        got = np.asarray(body["imputed"], np.float32)
        if got.shape != (2, 784) or len(body["row_score"]) != 2:
            raise AssertionError("bad HTTP response shape")
        np.testing.assert_array_equal(got * mask[:2], x[:2])
        if fep.embed_pool.launches != before + 1:
            raise AssertionError("the HTTP request did not run embed_pool")
        print("POST /impute: 2 rows back", flush=True)

    def step_timer():
        """on_step hook of train(): a CUDA event and the host clock at the
        end of each step's enqueue."""
        marks = []

        def on_step(epoch, step, loss):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((epoch, ev, time.perf_counter()))

        def medians():
            """Median step time after the first epoch (ms): CUDA events
            between consecutive step ends, and the host clock."""
            torch.cuda.synchronize()
            later = [(e, ev, t) for e, ev, t in marks if e >= 1]
            dev = [a[1].elapsed_time(b[1]) for a, b in zip(later, later[1:])]
            host = [(b[2] - a[2]) * 1e3 for a, b in zip(later, later[1:])]
            return statistics.median(dev), statistics.median(host)

        return on_step, medians

    train_cfg = RunConfig(vae_type="reg_EDDI1", data_type="mnist",
                          missing_rate=30, seed=SEED, epoch=MNIST_EPOCHS,
                          batch_size=64)
    with phase("training MNIST reg_EDDI1 / kl_reg (a): first step, card vs "
               "CPU"):
        mnist = loaders.data_loader_mnist(str(REPO / "Data"),
                                          train_cfg.vae_type,
                                          train_cfg.missing_rate, 64,
                                          device="cuda")
        model = get_model(train_cfg)
        cpu_params = model.init(torch.Generator().manual_seed(SEED),
                                train_cfg, 784, device="cpu")
        recorded = []
        card_gen_noise = trainer.GeneratorNoise(SEED + 1, "cuda")

        def recording(kind, epoch, step, shape):
            t = card_gen_noise(kind, epoch, step, shape)
            recorded.append(t)
            return t

        def first_step(params, x, m, noise):
            leaves = {k: v.clone().requires_grad_()
                      for k, v in checkpoint.flatten(params).items()}
            eff, mask_p, eps, eps_z = trainer.draw_step(train_cfg, noise, m,
                                                        0, 0)
            loss, _ = model.train_loss(checkpoint.unflatten(leaves), x, eff,
                                       mask_p, eps, 1.0, train_cfg,
                                       eps_z=eps_z)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            return loss.detach(), dict(zip(leaves, grads))

        xb, mb = mnist.train.x[:64], mnist.train.mask[:64]
        card_params = {k: v.cuda() for k, v in
                       checkpoint.flatten(cpu_params).items()}
        reset_counts()
        card_loss, card_grads = first_step(checkpoint.unflatten(card_params),
                                           xb, mb, recording)
        step_counts = counts()
        if step_counts != {k: 1 for k in step_counts}:
            raise AssertionError(f"one step launched {step_counts}")
        replay = iter([t.cpu() for t in recorded])
        cpu_loss, cpu_grads = first_step(
            cpu_params, xb.cpu(), mb.cpu(),
            lambda kind, epoch, step, shape: next(replay))
        torch.testing.assert_close(card_loss.cpu(), cpu_loss,
                                   rtol=STEP_LOSS_RTOL, atol=0)
        worst = 0.0
        for key, g in cpu_grads.items():
            scale = g.abs().max().item()
            diff = max_abs(card_grads[key].cpu(), g)
            if diff > STEP_GRAD_REL * scale:
                raise AssertionError(f"gradient {key}: card vs CPU max abs "
                                     f"diff {diff:.3e} > {STEP_GRAD_REL} * "
                                     f"{scale:.3e}")
            worst = max(worst, diff / scale if scale else 0.0)
        print(f"first step: loss card {card_loss.item():.6f} CPU "
              f"{cpu_loss.item():.6f}; {len(cpu_grads)} gradient leaves, "
              f"worst max|diff| / max|leaf| {worst:.3e}; launches "
              f"{step_counts}",
              flush=True)

    with tempfile.TemporaryDirectory() as ckpt_root:
        with phase(f"training MNIST reg_EDDI1 / kl_reg (b): {MNIST_EPOCHS} "
                   "epochs"):
            on_step, mnist_medians = step_timer()
            steps_per_epoch = -(-mnist.train.n // 64)
            reset_counts()
            t0 = time.perf_counter()
            trained, hist = trainer.train(mnist, train_cfg,
                                          experiments_root=ckpt_root,
                                          device="cuda", on_step=on_step)
            mnist_s = time.perf_counter() - t0
            mnist_counts = counts()
            n_steps = MNIST_EPOCHS * steps_per_epoch
            print(f"{mnist.train.n} rows, {n_steps} steps in {mnist_s:.3f} s; "
                  f"launches {mnist_counts}", flush=True)
            if mnist_counts != {k: n_steps for k in mnist_counts}:
                raise AssertionError(f"{n_steps} steps launched "
                                     f"{mnist_counts}")
            means = [h / steps_per_epoch for h in hist]
            print(f"mean loss per epoch: {means}", flush=True)
            if not (np.isfinite(hist).all() and means[-1] < means[0]):
                raise AssertionError(f"the MNIST loss did not fall: {means}")
            mnist_dev_ms, mnist_host_ms = mnist_medians()
            print(f"MNIST step p50 after the first epoch: {mnist_dev_ms:.6f} "
                  f"ms (CUDA events), {mnist_host_ms:.6f} ms (host clock) "
                  f"[{card}]", flush=True)

        with phase("training MNIST reg_EDDI1 / kl_reg (c): checkpoint round "
                   "trip, served"):
            loaded = trainer.load_trained(mnist, train_cfg,
                                          experiments_root=ckpt_root,
                                          device="cuda")
            got, want = checkpoint.flatten(loaded), checkpoint.flatten(trained)
            if sorted(got) != sorted(want) or any(
                    not torch.equal(got[k], want[k]) for k in want):
                raise AssertionError("the reloaded checkpoint differs")
            srv2 = serve.ImputationServer(loaded, train_cfg, 784,
                                          device="cuda")
            filled, score = srv2.impute(x, mask)
            if not (np.isfinite(filled).all() and np.isfinite(score).all()):
                raise AssertionError("non-finite output from the trained "
                                     "model")
            np.testing.assert_array_equal(filled * mask, x)
            print(f"{checkpoint.checkpoint_path(train_cfg, '<tmp>')} reloaded "
                  f"({len(got)} leaves); served {len(x)} rows, row score "
                  f"mean {float(score.mean()):.6f}", flush=True)

    wine_cfg = RunConfig(seed=SEED, epoch=WINE_EPOCHS, batch_size=64)
    with phase(f"training flagship {wine_cfg.vae_type} / {wine_cfg.reg_type} "
               f"on {wine_cfg.data_type}: {WINE_EPOCHS} epochs"):
        wine = loaders.data_loader(str(REPO / "Data"), wine_cfg.vae_type,
                                   wine_cfg.missing_rate, 64,
                                   wine_cfg.data_type, device="cuda")
        on_step, wine_medians = step_timer()
        wine_steps = -(-wine.train.n // 64)
        reset_counts()
        _, wine_hist = trainer.train(wine, wine_cfg, save=False,
                                     device="cuda", on_step=on_step)
        wine_counts = counts()
        n_steps = WINE_EPOCHS * wine_steps
        print(f"{wine.train.n} rows x {wine.obs_dim}, {n_steps} steps; "
              f"launches {wine_counts}", flush=True)
        if wine_counts != {"embed_pool_fwd": 0, "embed_pool_bwd": 0,
                           "fused_posterior_fwd": n_steps}:
            raise AssertionError(f"{n_steps} steps launched {wine_counts}")
        means = [h / wine_steps for h in wine_hist]
        print(f"mean loss, first and last epoch: {means[0]:.6f} -> "
              f"{means[-1]:.6f}", flush=True)
        if not (np.isfinite(wine_hist).all() and means[-1] < means[0]):
            raise AssertionError(f"the wine loss did not fall: {means}")
        wine_dev_ms, wine_host_ms = wine_medians()
        print(f"wine step p50 after the first epoch: {wine_dev_ms:.6f} ms "
              f"(CUDA events), {wine_host_ms:.6f} ms (host clock) [{card}]",
              flush=True)

    times = {}

    def timed(label, fn, plain, bound):
        """Time `fn` and its plain version `plain` (CUDA events), count the
        device operations of one call of `fn`, print them beside `bound`
        ((ms, 'bytes' or 'operations')) and return (ms, plain ms, bound ms,
        bound by, operations a call)."""
        k_ms = event_ms(fn)
        p_ms = event_ms(plain)
        n_ops = device_ops(fn)
        print(f"{label}: kernel {k_ms:.6f} ms ({n_ops} device operations a "
              f"call), plain {p_ms:.6f} ms, bound {bound[0]:.6f} ms "
              f"({bound[1]}) [{card}]", flush=True)
        return k_ms, p_ms, bound[0], bound[1], n_ops

    with phase("timings"):
        # what one launch of a trivial PyTorch kernel costs on this timing
        one = torch.zeros(1, device="cuda")
        floor_ms = event_ms(lambda: one.add_(1.0))
        print(f"launch floor: a 1-element torch add_ {floor_ms:.6f} ms "
              f"[{card}]", flush=True)
        # B2f at the serving shape, as ImputationServer launches it
        S, B = 1, 512
        A, C = layers._pointnet_affine(params["encoder"])
        xt = torch.from_numpy(np.concatenate(
            [x, np.zeros((B - len(x), 784), np.float32)])).cuda()
        mt = torch.from_numpy(np.concatenate(
            [mask, np.ones((B - len(x), 784), np.float32)]))[None].cuda()
        with torch.no_grad():
            timed(f"B2f EmbedPool.forward S={S} B={B} (serving)",
                  lambda: fep.embed_pool(xt, mt, A, C),
                  lambda: fep.embed_pool_reference(xt, mt, A, C),
                  embed_pool_bound_ms(S, B, D, K))

        # B2f and B2b as a training step launches them (S=2, B=64), then
        # at S=2, B=4096, where the bytes and not the launch set the time
        for S, B in ((2, 64), (2, 4096)):
            tag = ("training" if B == 64 else
                   "diagnostic: bytes, not the launch, set the time")
            x2, m2, A2, C2 = inputs(S, B)
            g2 = torch.randn(S, B, K, device="cuda", generator=gen)
            with torch.no_grad():
                fwd = timed(f"B2f EmbedPool.forward S={S} B={B} ({tag})",
                            lambda: fep.embed_pool(x2, m2, A2, C2),
                            lambda: fep.embed_pool_reference(x2, m2, A2, C2),
                            embed_pool_bound_ms(S, B, D, K))
            # the step's backward: A and C need a gradient, x and masks not
            Ar, Cr = A2.clone().requires_grad_(), C2.clone().requires_grad_()
            agg = fep.embed_pool(x2, m2, Ar, Cr)
            bwd = timed(
                f"B2b EmbedPool.backward S={S} B={B}, dA and dC only ({tag})",
                lambda: torch.autograd.grad(agg, (Ar, Cr), g2,
                                            retain_graph=True),
                lambda: fep.embed_pool_bwd_reference(x2, m2, A2, C2, g2),
                embed_pool_bwd_bound_ms(S, B, D, K, dx=False, dmasks=False))
            if B == 64:
                times["embed_pool_fwd"], times["embed_pool_bwd"] = fwd, bwd
            timed(f"B2b embed_pool_bwd standalone S={S} B={B}, all four "
                  f"outputs ({tag})",
                  lambda: fep.embed_pool_bwd(x2, m2, A2, C2, g2),
                  lambda: fep.embed_pool_bwd_reference(x2, m2, A2, C2, g2),
                  embed_pool_bwd_bound_ms(S, B, D, K))

        Bq, L = 64, LATENT
        st = stats(Bq, L)
        times["fused_posterior_fwd"] = timed(
            f"B1 fused_posterior [{Bq},{L}]",
            lambda: fp.fused_posterior_kernel(*st),
            lambda: fp.fused_posterior_reference(*st),
            fused_posterior_bound_ms(Bq, L))

        timed_srv = serve.ImputationServer(params, cfg, 784,
                                           device="cuda").warmup()
        for n, bucket in ((64, 64), (179, 512)):
            lat = []
            for _ in range(TIMING_RUNS):
                t0 = time.perf_counter()
                timed_srv.impute(x[:n], mask[:n])
                lat.append((time.perf_counter() - t0) * 1e3)
            print(f"request of {n} rows (bucket {bucket}): p50 "
                  f"{statistics.median(lat):.6f} ms over {TIMING_RUNS} "
                  f"[{card}]", flush=True)

    print(f"total {time.perf_counter() - t_start:.3f} s", flush=True)
    csrc = "vae_posterior_consistency_tpu_torch/csrc/"
    jax_ops = "vae_posterior_consistency_tpu/ops/"
    where = {
        "embed_pool_fwd": (csrc + "embed_pool.cu",
                           jax_ops + "fused_embed_pool.py:155"),
        "embed_pool_bwd": (csrc + "embed_pool.cu",
                           jax_ops + "fused_embed_pool.py:178"),
        "fused_posterior_fwd": (csrc + "fused_posterior.cu",
                                jax_ops + "fused_posterior.py:94"),
    }
    kernels = []
    for name, (source, replaces) in where.items():
        k_ms, p_ms, b_ms, b_by, n_ops = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": mnist_counts[name],
            "launches_per_call": n_ops,
            "max_abs_err": max_err[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Run from the root of a checkout. It drives only the port
(vae_posterior_consistency_tpu_torch), never JAX, in six phases:

1. environment: the card's name and power limit, torch and CUDA versions;
   TF32 off for every comparison;
2. build: every kernel in vae_posterior_consistency_tpu_torch/csrc/ with
   nvcc (plain C interface, loaded with ctypes);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the serving path gives it;
4. serving: the trained MNIST reg_EDDI1 checkpoint in the repo (reference
   state_dict, mapped by the port) behind ImputationServer(device="cuda"),
   imputing the 179 MNIST test rows in requests of 1, 8, 64 and 179 rows.
   Observed cells must come back unchanged and every output finite; the
   kernel's launch count must rise by one per request; a CPU server (the
   kernels' plain versions) fed the same noise must agree; the trained model
   must beat filling each missing cell with its column's observed mean;
5. one HTTP round trip to the server on a free port;
6. timings with CUDA events and the host clock.

It prints a JSON line of the kernels (launches on the serving run, error
against the plain version, times, bound), then, as its last line,
{"ok": true, "device": {...}}. Without CUDA, outside a checkout, or when any
phase fails, it exits nonzero and prints no result. A watchdog ends the run
after 300 s. It writes nothing but the kernels' build directory.
"""

import faulthandler

faulthandler.dump_traceback_later(300, exit=True)

import contextlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
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
#: kernel against its plain version: the sums over d run in another order
KERNEL_TOL = dict(rtol=1e-5, atol=1e-4)
#: the card's server against the CPU server (plain versions), same noise.
#: Imputed cells: atol 1e-4. A row score sums 784 cells, and its running sum
#: is ~1e3 whatever the score (the constant terms alone are 784*log(sqrt(2pi))
#: and 0.5*log(0.02) per observed cell), so float32 rounding in another
#: summation order moves it by about 1e3 * 2**-24 * sqrt(784) ~ 2e-3 whatever
#: its value: atol 5e-3.
SERVE_ATOL = 1e-4
SERVE_SCORE_ATOL = 5e-3
REQUEST_ROWS = (1, 8, 64, 179)
TIMING_RUNS = 100


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
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def embed_pool_bound_ms(S, B, D, K):
    """Least time for the function on the card: each input read once, the
    output written once, over the memory rate; or its (3+2S)*B*D*K float32
    operations over the float32 rate, whichever is larger."""
    nbytes = 4 * (B * D + S * B * D + 2 * D * K + S * B * K)
    ops = (3 + 2 * S) * B * D * K
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
              f"{torch.cuda.get_device_name(0)}, "
              f"{torch.cuda.device_count()} device(s)", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from vae_posterior_consistency_tpu_torch.config import RunConfig
    from vae_posterior_consistency_tpu_torch.data import loaders
    from vae_posterior_consistency_tpu_torch.engine import checkpoint, serve
    from vae_posterior_consistency_tpu_torch.models import layers
    from vae_posterior_consistency_tpu_torch.ops import _build
    from vae_posterior_consistency_tpu_torch.ops import fused_embed_pool as fep

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

    def inputs(S, B):
        x = torch.rand(B, D, device="cuda", generator=gen)
        masks = (torch.rand(S, B, D, device="cuda", generator=gen)
                 < 0.7).float()
        A = torch.randn(D, K, device="cuda", generator=gen) * 0.3
        C = torch.randn(D, K, device="cuda", generator=gen) * 0.3
        return x, masks, A, C

    with phase("kernel against its plain version"):
        max_err = 0.0
        for S, B in [(1, 1), (1, 8), (1, 64), (1, 179), (1, 512), (2, 64)]:
            args = inputs(S, B)
            got = fep.embed_pool(*args)
            torch.cuda.synchronize()
            want = fep.embed_pool_reference(*args)
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            torch.testing.assert_close(got, want, **KERNEL_TOL)
            print(f"embed_pool S={S} B={B} D={D} K={K}: max abs diff "
                  f"{err:.3e}", flush=True)

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
        fep.embed_pool.launches = 0
        outs = [srv.impute(x[:n], mask[:n]) for n in REQUEST_ROWS]
        launches = fep.embed_pool.launches
        print(f"embed_pool launches while serving {len(REQUEST_ROWS)} "
              f"requests: {launches}", flush=True)
        if launches != len(REQUEST_ROWS):
            raise AssertionError(f"embed_pool ran {launches} times for "
                                 f"{len(REQUEST_ROWS)} requests")

        replay = iter([e.cpu() for e in drawn])
        cpu_srv = serve.ImputationServer(params, cfg, 784, device="cpu",
                                         noise=lambda ctr, shape: next(replay))
        for n, (filled, score) in zip(REQUEST_ROWS, outs):
            if filled.shape != (n, 784) or score.shape != (n,):
                raise AssertionError(f"bad shapes {filled.shape} {score.shape}")
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

    with phase("timings"):
        S, B = 1, 512
        A, C = layers._pointnet_affine(params["encoder"])
        xt = torch.from_numpy(np.concatenate(
            [x, np.zeros((B - len(x), 784), np.float32)])).cuda()
        mt = torch.from_numpy(np.concatenate(
            [mask, np.ones((B - len(x), 784), np.float32)]))[None].cuda()
        kernel_ms = event_ms(lambda: fep.embed_pool(xt, mt, A, C))
        plain_ms = event_ms(lambda: fep.embed_pool_reference(xt, mt, A, C))
        bound_ms, bound_by = embed_pool_bound_ms(S, B, D, K)
        print(f"embed_pool S={S} B={B}: kernel {kernel_ms:.6f} ms, plain "
              f"{plain_ms:.6f} ms, bound {bound_ms:.6f} ms ({bound_by}) "
              f"[{card}]", flush=True)
        timed = serve.ImputationServer(params, cfg, 784,
                                       device="cuda").warmup()
        for n, bucket in ((64, 64), (179, 512)):
            lat = []
            for _ in range(TIMING_RUNS):
                t0 = time.perf_counter()
                timed.impute(x[:n], mask[:n])
                lat.append((time.perf_counter() - t0) * 1e3)
            print(f"request of {n} rows (bucket {bucket}): p50 "
                  f"{statistics.median(lat):.6f} ms over {TIMING_RUNS} "
                  f"[{card}]", flush=True)

    print(f"total {time.perf_counter() - t_start:.3f} s", flush=True)
    print(json.dumps({"kernels": [{
        "name": "embed_pool_fwd",
        "route": "cuda",
        "source": "vae_posterior_consistency_tpu_torch/csrc/embed_pool.cu",
        "replaces": "vae_posterior_consistency_tpu/ops/fused_embed_pool.py:155",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where a training step's time goes on the card: step time, the device's busy
time and idle share, kernel launches a step, and the top kernels by device
time and operators by host time, from `torch.profiler` over a window of
steady-state steps.

    python -m vae_posterior_consistency_tpu_torch.engine.profile_train \
        [--steps 30] [--trace-dir DIR]

Runs two configurations at full width: MNIST `reg_EDDI1` / `kl_reg` (the
EDDI two-mask path, kernels B1, B2f and B2b) and the flagship wine
`reg_vae1` / `kl_reg` (dense path, kernel B1), batch 64, from seeded random
parameters. Each gets 20 warm-up steps, then `--steps` steps timed on the
host clock between two synchronisations, then the same number of steps
under the profiler. Needs a CUDA card; `--trace-dir` also writes a Chrome
trace per configuration.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.data import loaders
from vae_posterior_consistency_tpu_torch.engine import checkpoint, train
from vae_posterior_consistency_tpu_torch.models import get_model

WARMUP_STEPS = 20


def _run(cfg: RunConfig, data: loaders.Dataset, steps: int, trace_dir):
    device = torch.device("cuda")
    model = get_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(cfg.seed),
                        cfg, data.obs_dim, device=device)
    params = checkpoint.unflatten({
        k: v.requires_grad_(True)
        for k, v in checkpoint.flatten(params).items()})
    optimizer = train.make_optimizer(params)
    step_fn = train.make_train_step(cfg, model)
    noise = train.GeneratorNoise(cfg.seed + 1, device)
    x, mask = data.train.x, data.train.mask
    bsz = min(cfg.batch_size, data.train.n)
    n_batches = data.train.n // bsz

    def run(n, offset):
        for i in range(n):
            rows = slice((i % n_batches) * bsz, (i % n_batches + 1) * bsz)
            step_fn(params, optimizer, x[rows], mask[rows], noise, 0,
                    offset + i)

    run(WARMUP_STEPS, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps, WARMUP_STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(steps, WARMUP_STEPS + steps)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / steps
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"train_{cfg.vae_type}_{cfg.data_type}.json"))
    # device work: kernels, copies and fills on the card's timeline (not
    # the ranges the profiler draws there for annotations like
    # Optimizer.step, which span their kernels and the gaps between them)
    on_card = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in on_card):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    device_ms = busy_us / 1e3 / steps
    by_name = collections.Counter()
    for e in on_card:
        by_name[e.name[:70]] += e.time_range.elapsed_us() / 1e3 / steps
    events = prof.key_averages()
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC")) / steps
    top_host = sorted(events, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:12]
    return {
        "config": f"{cfg.vae_type}/{cfg.reg_type} on {cfg.data_type}, "
                  f"batch {bsz}, obs_dim {data.obs_dim}",
        "step_ms": step_ms,
        "step_ms_profiled": prof_ms,
        "device_busy_ms_per_step": device_ms if on_card else None,
        "device_idle_share": (1.0 - device_ms / prof_ms) if on_card else None,
        "device_ops_per_step": len(on_card) / steps,
        "kernel_launches_per_step": launches,
        "top_device_ms_per_step": by_name.most_common(12),
        "top_host_self_ms_per_step": [
            (e.key[:70], e.self_cpu_time_total / 1e3 / steps)
            for e in top_host],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--trace-dir", default="")
    ap.add_argument("--data-path", default="Data")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    mnist_cfg = RunConfig(vae_type="reg_EDDI1", data_type="mnist",
                          missing_rate=30)
    mnist = loaders.data_loader_mnist(args.data_path, mnist_cfg.vae_type,
                                      mnist_cfg.missing_rate, 64,
                                      device="cuda")
    wine_cfg = RunConfig()
    wine = loaders.data_loader(args.data_path, wine_cfg.vae_type,
                               wine_cfg.missing_rate, 64, wine_cfg.data_type,
                               device="cuda")
    for cfg, data in ((mnist_cfg, mnist), (wine_cfg, wine)):
        out = _run(cfg, data, args.steps, args.trace_dir)
        out["card"] = card
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

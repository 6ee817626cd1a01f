"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up makes the cell's inputs and weights
from the seed on the card and warms up the shapes its traffic uses; the
window then drives the program for `--seconds` seconds (`--trace 1`: under
torch.profiler, and the cell's per-layer metrics are read from the trace
and from what the driver did); the reference then checks the window's
answers. The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and last `checks`, each compared number with its limit; the same numbers
are the last lines of standard error.

Exits non-zero, with no result line, without a CUDA device (or with fewer
than the cell asks for), and when the JAX package or JAX was loaded. A
cell of `benchmark/pending.json` runs too, with a note on standard error
that it is not gated.
`--variant` (not used by the benchmark's own runs) runs a control or a
planted fault for `tools/control.py` and the harness's tests.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# one host thread for the CPU's own tensor work: the run's host time is
# the program's dispatch, and a single-threaded process shares the card's
# host with the fewest other threads
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "1")

from harness import cells  # noqa: E402

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "vae_posterior_consistency_tpu")

VARIANTS = ("tf32", "bf16", "unchanged", "unchanged_in_window", "half_batch",
            "altered")

#: the longest window a `--trace 1` run traces: the per-layer metrics are
#: read from it, and a longer trace takes minutes to read back
TRACE_SECONDS = 10.0


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--variant", choices=VARIANTS, default=None)
    ap.add_argument("--rate", type=float, default=None,
                    help="serving cells: offer this rate instead of the "
                    "traffic file's (the knee sweep)")
    return ap.parse_args(argv)


def forbidden_modules():
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def _caches():
    """Build and kernel caches inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run(args, device="cuda", overrides=None):
    """One run; returns (result dict, stderr lines) or raises."""
    import torch

    torch.set_num_threads(1)
    cell = cells.resolve(args.workload)
    cell.reference_module = cells.reference(cell)
    if args.rate is not None:
        cell.traffic["rate_per_s"] = args.rate
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device == "cuda"
    drv = cells.driver(cell).Driver(cell, args.seed, device, args.variant,
                                    overrides)
    seconds = min(args.seconds, TRACE_SECONDS) if args.trace else (
        args.seconds)
    drv.setup(seconds)

    from harness.trace import Window
    with Window(bool(args.trace),
                sync=torch.cuda.synchronize if cuda else None) as win:
        if not drv.opens_window:
            win.open()
        drv.window(seconds, win)
    setup_s = win.opened - T0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    lines = list(getattr(drv, "notes", lambda: [])())
    lines.append("units of work a second by quarter of the window: "
                 + " ".join(f"{r:.6g}" for r in win.quarters()))
    metrics, device_info, breakdown = {}, {}, None
    if args.trace:
        ctx = drv.context(win)
        ctx.update(window=win, window_s=win.seconds)
        lines.append(f"card: {_power_limit() if cuda else 'cpu'} "
                     "(mfu and rooflines against the H100 SXM data sheet)")
        for m in cell.per_layer:
            value = cells.metric_reader(m["name"]).read(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info = {"busy_s": win.busy_s(), "window_s": win.seconds}
        breakdown = {"device_ops": win.top_device_ops(),
                     "idle_gaps": win.idle_gaps()}
    else:
        values = drv.end_to_end(win)
        values["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    attempted, failed = drv.attempted(), drv.failed
    drv.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers = drv.check()

    checks = {}
    for name, value in numbers.items():
        if name not in cell.limits:
            raise KeyError(f"no limit for {name!r} in limits/{cell.name}"
                           ".json")
        checks[name] = {"value": value, "limit": cell.limits[name]["limit"]}
    correct = (failed == 0 and attempted > 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    result = {
        "correct": correct, "attempted": attempted, "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell.chips if cuda else 0,
            "memory_peak_bytes": peak, **device_info},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    lines += [f"check {k}: {c['value']!r} limit {c['limit']!r}"
              for k, c in checks.items()]
    return result, lines


def main(argv=None):
    args = parse(argv)
    _caches()
    import torch

    chips = {w["name"]: w["chips"] for w in cells.load_all()["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if args.workload not in {w["name"] for w in
                             cells.load_spec()["workloads"]}:
        print(f"{args.workload} is a pending cell (benchmark/pending.json),"
              " not a cell of BENCHMARK.json", file=sys.stderr)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < chips[args.workload]):
        print("a CUDA device is needed: found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f", the cell asks for {chips[args.workload]}", file=sys.stderr)
        return 2
    result, lines = run(args)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

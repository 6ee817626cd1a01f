"""Run cells of the benchmark as the check runs them, one process a run,
and keep every result line.

    python3 benchmark/tools/series.py --cells eddi_wine.train \
        --seeds 11 12 13 --seconds 10 --trace 0 --out chiprun_out/x.jsonl

Each run is `python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <t>` from the checkout's root; the file gets one JSON
line a run (cell, seed, trace, exit code, wall seconds, the result line,
the end of standard error). `--spread` prints each metric's quartile
spread (`statistics.quantiles(values, n=4)`, (q3 - q1) / median) per cell.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def one(cell, seed, seconds, trace, extra=()):
    cmd = [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
           str(seed), "--seconds", str(seconds), "--trace", str(trace),
           *extra]
    t = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=420)
    wall = time.perf_counter() - t
    lines = p.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"cell": cell, "seed": seed, "trace": trace, "rc": p.returncode,
            "wall_s": wall, "extra": list(extra), "result": result,
            "stderr": p.stderr[-3000:]}


def spread(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="+", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--rate", type=float, default=None,
                    help="serving cells: the offered rate (the knee sweep)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print("card:", smi.stdout.strip(), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    runs = []
    with out.open("a") as f:
        for cell in args.cells:
            for seed in args.seeds:
                extra = [] if args.rate is None else ["--rate",
                                                      str(args.rate)]
                r = one(cell, seed, args.seconds, args.trace, extra)
                runs.append(r)
                f.write(json.dumps(r) + "\n")
                f.flush()
                res = r["result"] or {}
                print(cell, seed, "rc", r["rc"], "wall %.1f" % r["wall_s"],
                      "correct", res.get("correct"),
                      {k: v["value"] for k, v in res.get("metrics",
                                                          {}).items()},
                      {k: v["value"] for k, v in res.get("checks",
                                                          {}).items()},
                      flush=True)
                if r["rc"] != 0 or not res:
                    print(r["stderr"][-1500:], flush=True)
    for cell in args.cells:
        rs = [r["result"] for r in runs if r["cell"] == cell and r["result"]]
        if len(rs) < 3:
            continue
        for name in rs[0]["metrics"]:
            vals = [r["metrics"][name]["value"] for r in rs]
            print("spread", cell, name, "median %.6g" %
                  statistics.median(vals), "spread %.5f" % spread(vals))


if __name__ == "__main__":
    main()

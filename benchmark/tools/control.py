"""Read a cell's compared numbers under the sound program, its controls
and its planted faults, on many seeds, in one process.

    python3 benchmark/tools/control.py --workload eddi_wine.train \
        --seeds 1 2 3 --variants none tf32 bf16 --seconds 3 \
        --out chiprun_out/control.jsonl

A variant is one of `run.py`'s: `none` (the program as the configuration
states it: the lower readings), `tf32` (the reference, its products'
operands rounded to TF32, in the program's place: the control), `bf16`
(the program's own bfloat16 path), and the faults `unchanged`,
`half_batch`, `altered`. The window is short: the numbers need the
window's answers, not its length. One JSON line a run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    ap.add_argument("--variants", nargs="+", default=["none", "tf32"])
    ap.add_argument("--seconds", type=float, default=3)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    run._caches()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for variant in args.variants:
            for seed in args.seeds:
                argv = ["--workload", args.workload, "--seed", str(seed),
                        "--seconds", str(args.seconds)]
                if variant != "none":
                    argv += ["--variant", variant]
                result, _ = run.run(run.parse(argv))
                checks = {k: c["value"] for k, c in result["checks"].items()}
                rec = {"cell": args.workload, "variant": variant,
                       "seed": seed, "correct": result["correct"],
                       "checks": checks}
                f.write(json.dumps(rec) + "\n")
                f.flush()
                print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()

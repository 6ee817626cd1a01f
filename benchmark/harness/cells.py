"""Resolve a cell of `BENCHMARK.json` from its files, by name alone.

A cell `<config>.<traffic>` is the entry of `workloads` with that name. Its
files:
- `benchmark/configs/<config>.json` (the `file` of its `configs` entry):
  the model's sizes, its source, `reduced`, `assumed`, and `reference`,
  the plain reference module beside it under `benchmark/reference/`;
- `benchmark/traffic/<traffic>.json`: the traffic mix's parameters, and
  `driver`, the general generator under `benchmark/drivers/` that reads
  them;
- `benchmark/limits/<cell>.json`: each number the correctness check
  compares, with its limit and the two readings it was set from.
A metric belongs to the cell when its `workloads` list names it (or, for a
metric without the key, always).

`benchmark/pending.json` holds, in `BENCHMARK.json`'s sections, the cells
that are built and proven correct but not yet gated (`PERF.md` says why);
they resolve like the others, for measurement and for the harness's own
tests, and the benchmark's check never runs them. A benchmark PR gates one
by moving its entries into `BENCHMARK.json`. A per-layer metric `<base>.<suffix>` is
read by `benchmark/metrics/<base>.<suffix>.py` where that file exists,
else by `benchmark/metrics/<base>.py`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = ROOT / "BENCHMARK.json"
PENDING = BENCH / "pending.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_spec(path: Path = SPEC) -> dict:
    return json.loads(path.read_text())


def load_all() -> dict:
    """`BENCHMARK.json` with the pending cells' entries added: a metric
    named in both lists the cells of both, or, where either entry has no
    `workloads` key, stays reported in every cell."""
    spec = load_spec()
    pending = json.loads(PENDING.read_text())
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        by = {e["name"]: dict(e) for e in spec[section]}
        for e in pending[section]:
            if e["name"] not in by:
                by[e["name"]] = dict(e)
            elif "workloads" in e and "workloads" in by[e["name"]]:
                by[e["name"]]["workloads"] = (by[e["name"]]["workloads"]
                                              + e["workloads"])
        spec[section] = list(by.values())
    return spec


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, spec: dict | None = None) -> Cell:
    spec = load_all() if spec is None else spec
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = _json(ROOT / conf["file"])
    traffic = _json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = _json(BENCH / "limits" / f"{name}.json")
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"]
                           if _applies(m, name)])


def load_module(path: Path, name: str):
    """Import the file `path` as a module called `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    return load_module(BENCH / "drivers" / f"{cell.traffic['driver']}.py",
                       f"bench_driver_{cell.traffic['driver']}")


def reference(cell: Cell):
    return load_module(BENCH / "reference" / cell.config["reference"],
                       "bench_reference_" + Path(
                           cell.config["reference"]).stem)


def metric_reader(name: str):
    """The reader of per-layer metric `name`: its own file, or its base's
    (the part before the first dot)."""
    for stem in (name, name.split(".")[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.exists():
            return load_module(path, "bench_metric_" + stem.replace(".", "_"))
    raise FileNotFoundError(f"no reader for per-layer metric {name!r} under "
                            f"{BENCH / 'metrics'}")

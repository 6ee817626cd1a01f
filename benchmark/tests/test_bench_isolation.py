"""What runs on the card loads neither JAX nor the JAX package; the
reference loads nothing of the program; nothing in the benchmark reads the
JAX package's old benchmark files; without a card the run exits non-zero
and prints no result."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
JAX_NAMES = {"jax", "jaxlib", "flax", "vae_posterior_consistency_tpu"}

_RUN_CELL = r"""
import sys, json
sys.path[:0] = [{bench!r}, {root!r}]
import run
args = run.parse(["--workload", "eddi_wine.train", "--seed", "5",
                  "--seconds", "0.3", "--trace", "1"])
result, _ = run.run(args, device="cpu")
print(json.dumps(sorted(sys.modules)))
"""

_REFERENCE = r"""
import sys, json, importlib.util, torch
spec = importlib.util.spec_from_file_location(
    "ref", {path!r})
ref = importlib.util.module_from_spec(spec); spec.loader.exec_module(ref)
cfg = json.load(open({config!r}))
g = torch.Generator().manual_seed(0)
p = {{k: torch.rand(s, generator=g) * 2 * b - b
      for k, s, b in ref.param_specs(cfg)}}
x = torch.rand(64, cfg["obs_dim"], generator=g)
m = (x > 0.3).float()
ref.train_steps(p, cfg, [(x, m, torch.rand(64, cfg["obs_dim"]),
                          torch.randn(2, 64, cfg["latent_dim"]))])
ref.al_rewards(p, cfg, x[:4], m[:4] * 0, torch.rand(2, 4, cfg["obs_dim"]))
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_a_run_loads_no_jax():
    top = _modules(_RUN_CELL.format(bench=str(BENCH), root=str(ROOT)))
    assert "vae_posterior_consistency_tpu_torch" in top
    assert not top & JAX_NAMES


def test_reference_loads_nothing_of_the_program():
    top = _modules(_REFERENCE.format(
        path=str(BENCH / "reference" / "gauss_eddi.py"),
        config=str(BENCH / "configs" / "eddi_wine.json")))
    assert not top & (JAX_NAMES | {"vae_posterior_consistency_tpu_torch"})


def test_no_file_reads_the_old_benchmark():
    pattern = re.compile(r"\bbench\.py\b|BENCH_r|MULTICHIP_|tools/bench_")
    this = Path(__file__).name
    for path in BENCH.rglob("*"):
        if path.is_file() and path.suffix in (".py", ".json", ".sh") and (
                path.name != this):
            assert not pattern.search(path.read_text()), path


def test_reference_imports_only_torch():
    for path in (BENCH / "reference").glob("*.py"):
        imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)",
                             path.read_text(), re.M)
        assert {i.split(".")[0] for i in imports} <= {
            "__future__", "contextlib", "math", "torch"}, path


def test_without_a_card_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "eddi_wine.train",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the harness."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "eddi_wine.train",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

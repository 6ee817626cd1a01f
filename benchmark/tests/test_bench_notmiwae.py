"""The cell `notmiwae_wine_mnar.eval_mnar` on the CPU at a small size, and
what it adds to the harness: its driver (`drivers/eval_mnar.py`: the seeded
MNAR mask is the program's rule, the kept draws are complete, a call that
skipped a rep reads infinite), its plain reference (`reference/
notmiwae.py`) loads nothing of the program; the sound program is correct
and the TF32 control, the program's bf16 path, the altered answer and the
two planted faults are not; the readers of the three new per-layer metrics
on synthetic windows; the MNAR FLOP count at the published widths."""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import run
from counts import flops_mnar
from counts.kernels import PEAKS
from harness import cells, spans
from harness.trace import Window
from vae_posterior_consistency_tpu_torch.utils.tracing import Span

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CELL = "notmiwae_wine_mnar.eval_mnar"
#: a few rows at the published widths; K stays the configuration's 10,000
SMALL = {"config": {"rows": 12}, "traffic": {"sample_range": 1}}
SEED = 2**31 + 28


def _run(variant, seed=SEED, trace=0, seconds=0.3):
    args = run.parse(["--workload", CELL, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", str(trace)])
    # the planted faults are the driver's own variants, not run.py's
    args.variant = variant
    return run.run(args, device="cpu", overrides=SMALL)


def test_the_cell_resolves_to_its_driver_and_reference():
    c = cells.resolve(CELL)
    assert c.traffic["driver"] == "eval_mnar" and c.chips == 1
    assert cells.driver(c).Driver
    assert cells.reference(c).param_specs(c.config)
    assert {m["name"] for m in c.per_layer} == {
        "device_idle_pct.eval", "mfu_mnar.eval",
        "mnar_decode_device_pct.eval", "mnar_missingness_device_pct.eval"}
    assert {m["name"] for m in c.end_to_end} == {"eval_rows_per_s",
                                                "setup_s"}
    assert set(c.limits) == {"rmse_gap", "imputed_gap"}


@pytest.mark.parametrize("variant,correct", [
    (None, True), ("tf32", False), ("bf16", False), ("altered", False),
    ("half_k", False), ("no_missingness", False)], ids=str)
def test_cell_against_reference(variant, correct):
    result, _ = _run(variant)
    assert result["correct"] is correct, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"eval_rows_per_s", "setup_s"}


def test_the_reference_pins_valid_k(monkeypatch):
    """A program that scored fewer importance samples than the
    configuration states reads infinite."""
    from harness import program
    config = program.run_config

    monkeypatch.setattr(program, "run_config",
                        lambda *a, **k: config(*a, **{**k, "valid_k": 100}))
    result, _ = _run(None)
    assert result["correct"] is False
    assert result["checks"]["rmse_gap"]["value"] == math.inf


def _driver(seed=SEED):
    c = cells.resolve(CELL)
    c.reference_module = cells.reference(c)
    return cells.driver(c).Driver(c, seed, "cpu", None, SMALL)


def test_the_mnar_mask_is_the_programs_rule():
    """On the 13 wine columns the program's generator hides the first 6
    features above their column's mean and the loader drops the target;
    the driver's rule on the 12 columns left gives the same mask, on the
    raw table and on its min-max scaling."""
    from vae_posterior_consistency_tpu_torch.data import generate

    mod = cells.driver(cells.resolve(CELL))
    x13 = torch.rand(178, 13, generator=torch.Generator().manual_seed(3))
    want = torch.from_numpy(generate._mnar_mask(x13.numpy()))[:, :-1]
    x = x13[:, :-1]
    scaled = (x - x.amin(0)) / (x.amax(0) - x.amin(0))
    for table in (x, scaled):
        got = mod.mnar_mask(table, 6)
        assert got.dtype == torch.float32 and torch.equal(got, want)
    assert 0.2 < float(1 - want.mean()) < 0.3


def test_the_drivers_table_and_mask_come_from_the_seed():
    a, b, other = _driver(), _driver(), _driver(SEED + 1)
    for d in (a, b, other):
        d.setup()
    assert torch.equal(a.x, b.x) and torch.equal(a.mask, b.mask)
    assert not torch.equal(a.x, other.x)
    assert a.x.shape == (12, 12)
    assert torch.equal(a.mask, cells.driver(cells.resolve(CELL)).mnar_mask(
        a.x, 6))
    assert torch.equal(a.mask[:, 6:], torch.ones(12, 6))


def test_kept_draws_are_complete_and_a_skipped_rep_reads_infinite():
    d = _driver()
    d.setup()
    d.call(0)
    rmse, kept, imputed = d.kept[0]
    assert [(k, r, s) for k, r, s, _ in kept] == [("eps", 0, 0)]
    assert kept[0][3].shape == (12, 10000, 10)
    assert len(imputed) == 1 and imputed[0].shape == (12, 12)
    assert d.check()["rmse_gap"] < 1e-6
    d.kept[0] = (rmse, [], imputed)
    assert d.check() == {"rmse_gap": math.inf, "imputed_gap": math.inf}


def test_traced_run_on_the_cpu_reads_the_host_metrics():
    """No device operation on the CPU: the device shares read nothing, the
    window's FLOPs over the float32 peak are read."""
    result, _ = _run(None, trace=1, seconds=1.5)
    got = result["metrics"]
    assert result["correct"]
    assert got["mfu_mnar.eval"]["value"] > 0
    for name in ("device_idle_pct.eval", "mnar_decode_device_pct.eval",
                 "mnar_missingness_device_pct.eval"):
        assert name not in got


_REFERENCE = r"""
import sys, json, importlib.util, torch
spec = importlib.util.spec_from_file_location("ref", {path!r})
ref = importlib.util.module_from_spec(spec); spec.loader.exec_module(ref)
cfg = json.load(open({config!r}))
cfg["valid_k"] = 50
g = torch.Generator().manual_seed(0)
p = {{k: torch.rand(s, generator=g) * 2 * b - b
      for k, s, b in ref.param_specs(cfg)}}
x = torch.rand(20, cfg["obs_dim"], generator=g)
m = (x > 0.5).float()
r = ref.evaluate(p, cfg, x, m, torch.randn(20, 50, cfg["latent_dim"]))
assert torch.isfinite(r["rmse"])
print(json.dumps(sorted(sys.modules)))
"""


def test_reference_loads_nothing_of_the_program():
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE.format(
            path=str(BENCH / "reference" / "notmiwae.py"),
            config=str(BENCH / "configs" / "notmiwae_wine_mnar.json"))],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    top = {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}
    assert not top & {"jax", "jaxlib", "flax", "vae_posterior_consistency_tpu",
                      "vae_posterior_consistency_tpu_torch"}


# -- the FLOP count -----------------------------------------------------------


def test_flops_of_one_call_at_the_published_size():
    cfg = {**cells.resolve(CELL).config, "M": 1}
    # encoder 12-128-128 and two heads 128-10
    assert flops_mnar.encoder_row(cfg) == 2 * (
        12 * 128 + 128 * 128 + 2 * 128 * 10) == 40960
    # decoder 10-128-128 and two heads 128-12, and the imputation's 2 D
    assert flops_mnar.decoder_sample(cfg) == 2 * (
        10 * 128 + 128 * 128 + 2 * 128 * 12) + 2 * 12 == 41472 + 24
    assert flops_mnar.eval_call(cfg) == 178 * (40960 + 10000 * 41496)
    assert flops_mnar.eval_call(cfg) == pytest.approx(73.9e9, rel=1e-3)


def test_mfu_mnar_reads_the_windows_flops():
    reader = cells.metric_reader("mfu_mnar.eval")
    got = reader.read("mfu_mnar.eval", {"calls": 10, "flops": 7e11,
                                        "window_s": 2.0})
    assert got == pytest.approx(100.0 * 7e11
                                / (2.0 * PEAKS["float32_flops_per_s"]))
    assert reader.read("mfu_mnar.eval", {"calls": 0, "flops": 0,
                                         "window_s": 2.0}) is None
    assert reader.read("mfu_mnar.eval", {"window_s": 2.0}) is None


# -- the model's spans --------------------------------------------------------


def span(name, a, b, id, parent=None, root=None):
    return Span(name, a, b, id, parent, id if root is None else root, 1, {})


#: model [10, 90] holding decode [20, 40] and missingness [50, 70]
RECS = [span("notmiwae.decode", 20, 40, 2, parent=1, root=1),
        span("notmiwae.missingness", 50, 70, 3, parent=1, root=1),
        span("model.eval_step", 10, 90, 1)]
LAUNCHES = {1: 12, 2: 25, 3: 38, 4: 55, 5: 95}
OPS = [(1, 30, 35), (2, 45, 60), (3, 60, 75), (4, 80, 90), (5, 96, 99)]


def _ctx(monkeypatch, recs):
    from harness import launch_spans

    win = Window(False)
    win.host_ops = [("aten::op", 0, 100)]
    win.device_ops = [("kernel", a, b) for _, a, b in OPS]
    monkeypatch.setattr(spans, "_program_records", lambda: recs)
    monkeypatch.setattr(launch_spans, "read_launches",
                        lambda w: (LAUNCHES, OPS))
    return {"window": win, "window_s": 1e-7}


def test_the_readers_take_their_spans_share_of_the_busy_time(monkeypatch):
    ctx = _ctx(monkeypatch, RECS)
    busy = ctx["window"].busy_s() * 1e9
    decode = cells.metric_reader("mnar_decode_device_pct.eval")
    miss = cells.metric_reader("mnar_missingness_device_pct.eval")
    # 2 and 3 launched in decode (15 + 15 ns), 4 in missingness (10 ns)
    assert decode.read("mnar_decode_device_pct.eval", ctx) == (
        pytest.approx(100.0 * 30 / busy))
    assert miss.read("mnar_missingness_device_pct.eval", ctx) == (
        pytest.approx(100.0 * 10 / busy))


def test_without_the_span_the_readers_read_nothing(monkeypatch):
    """A program without the model's spans (the parent of the change that
    adds them) gives None, never 0."""
    ctx = _ctx(monkeypatch, [span("model.eval_step", 10, 90, 1)])
    for name in ("mnar_decode_device_pct.eval",
                 "mnar_missingness_device_pct.eval"):
        assert cells.metric_reader(name).read(name, ctx) is None

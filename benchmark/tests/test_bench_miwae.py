"""The cell `miwae_wine.eval` on the CPU at a small size, and what it adds
to the harness: its plain reference (`reference/miwae.py`) loads nothing of
the program; the sound program is correct and the TF32 control and the
planted faults are not; the launch-span attribution
(`harness/launch_spans.py`) and the readers of the three new per-layer
metrics on synthetic windows; the importance-weighted FLOP count."""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import run
from counts import flops_iw
from counts.kernels import PEAKS
from harness import cells, launch_spans, spans
from harness.trace import Window
from vae_posterior_consistency_tpu_torch.utils.tracing import Span

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CELL = "miwae_wine.eval"
#: a few rows at the published widths; K stays the configuration's 5000,
#: which the program takes from RunConfig's default
SMALL = {"config": {"rows_train": 24, "rows_test": 8},
         "traffic": {"sample_range": 1}}


def _run(variant, seed=2**31 + 24, trace=0, seconds=0.3):
    argv = ["--workload", CELL, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
    if variant:
        argv += ["--variant", variant]
    return run.run(run.parse(argv), device="cpu", overrides=SMALL)


@pytest.mark.parametrize("variant,correct", [
    (None, True), ("tf32", False), ("half_batch", False),
    ("altered", False)], ids=str)
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
    assert result["checks"]["means_gap"]["value"] == math.inf


def test_traced_run_on_the_cpu_reads_the_host_metrics():
    """No device operation on the CPU: the device shares read nothing, the
    host-clock and span metrics are read (a window of several calls: the
    first call's root span starts before the profiler's first event)."""
    result, _ = _run(None, trace=1, seconds=1.5)
    got = result["metrics"]
    assert result["correct"]
    assert got["mfu_iw.eval"]["value"] > 0
    assert got["host_reads_per_call.eval"]["value"] == 2.0
    assert "iw_decode_device_pct.eval" not in got
    assert "iw_likelihood_device_pct.eval" not in got


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
stats, _ = ref.evaluate_split(p, cfg, x, m, torch.randperm(20),
                              torch.randn(24, 50, cfg["latent_dim"]), 8)
assert torch.isfinite(stats).all()
print(json.dumps(sorted(sys.modules)))
"""


def test_reference_loads_nothing_of_the_program():
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE.format(
            path=str(BENCH / "reference" / "miwae.py"),
            config=str(BENCH / "configs" / "miwae_wine.json"))],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    top = {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}
    assert not top & {"jax", "jaxlib", "flax", "vae_posterior_consistency_tpu",
                      "vae_posterior_consistency_tpu_torch"}


def test_reference_tf32_round():
    ref = cells.reference(cells.resolve(CELL))
    t = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0])
    assert ref.tf32_round(t).tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10,
                                          -3.0]


# -- the FLOP count -----------------------------------------------------------


def test_flops_of_one_call_at_the_published_size():
    cfg = {**cells.resolve(CELL).config, "M": 1}
    assert flops_iw.padded_rows(cfg) == 3 * 64 + 17
    # 10-128-128-39, and the imputation's 2 D
    assert flops_iw.decoder_sample(cfg) == 2 * (
        10 * 128 + 128 * 128 + 128 * 39) + 2 * 13
    assert flops_iw.encoder_row(cfg) == 2 * (13 * 128 + 128 * 128 + 128 * 20)
    assert flops_iw.eval_call(cfg) == 209 * (41216 + 5000 * 45338)


def test_mfu_iw_reads_the_cells_widths():
    reader = cells.metric_reader("mfu_iw.eval")
    cfg = {**cells.resolve(CELL).config, "M": 1}
    got = reader.read("mfu_iw.eval", {"calls": 10, "window_s": 2.0})
    assert got == pytest.approx(100.0 * 10 * flops_iw.eval_call(cfg)
                                / (2.0 * PEAKS["float32_flops_per_s"]))
    assert reader.read("mfu_iw.eval", {"calls": 0, "window_s": 2.0}) is None
    assert reader.read("mfu_iw.eval", {"window_s": 2.0}) is None


# -- launch spans -------------------------------------------------------------


def span(name, a, b, id, parent=None, root=None):
    return Span(name, a, b, id, parent, id if root is None else root, 1, {})


#: model [10, 90] holding decode [20, 40] and likelihood [50, 70]
RECS = [span("miwae.decode", 20, 40, 2, parent=1, root=1),
        span("miwae.likelihood", 50, 70, 3, parent=1, root=1),
        span("model.eval_step", 10, 90, 1)]
#: launches (correlation id: host time) and the device operations they made,
#: which run later than their launch, some while the host is in a later span
LAUNCHES = {1: 12, 2: 25, 3: 38, 4: 55, 5: 95, 7: 5}
OPS = [(1, 30, 35), (2, 45, 60), (3, 60, 75), (4, 80, 90), (5, 96, 99),
       (6, 99, 100), (7, 101, 103)]


def test_each_operation_goes_to_the_innermost_span_at_its_launch():
    by = launch_spans.busy_by_launch_span(LAUNCHES, OPS,
                                          spans.in_range(RECS, 0, 100))
    # 2 and 3 were launched in decode though they ran in likelihood's time;
    # 6 has no launch; 5 and 7 were launched outside any span
    assert dict(by) == {"model.eval_step": 5, "miwae.decode": 15 + 15,
                        "miwae.likelihood": 10, spans.OUTSIDE: 3 + 2}


def test_overlapping_operations_count_once():
    ops = [(2, 45, 60), (3, 50, 65), (4, 70, 72)]
    by = launch_spans.busy_by_launch_span(LAUNCHES, ops,
                                          spans.in_range(RECS, 0, 100))
    assert by["miwae.decode"] == 20 and by["miwae.likelihood"] == 2


def test_launches_outside_the_range_are_left_out():
    by = launch_spans.busy_by_launch_span({1: 150}, [(1, 160, 170)],
                                          spans.in_range(RECS, 0, 100))
    assert not by


def _ctx(monkeypatch, recs, ops=OPS, launches=LAUNCHES):
    win = Window(False)
    win.host_ops = [("aten::op", 0, 100)]
    win.device_ops = [("kernel", a, b) for _, a, b in ops]
    monkeypatch.setattr(spans, "_program_records", lambda: recs)
    monkeypatch.setattr(launch_spans, "read_launches",
                        lambda w: (launches, ops))
    return {"window": win, "window_s": 1e-7}


def test_the_readers_take_their_spans_share_of_the_busy_time(monkeypatch):
    ctx = _ctx(monkeypatch, RECS)
    busy = ctx["window"].busy_s() * 1e9
    decode = cells.metric_reader("iw_decode_device_pct.eval")
    like = cells.metric_reader("iw_likelihood_device_pct.eval")
    assert decode.read("iw_decode_device_pct.eval", ctx) == pytest.approx(
        100.0 * 30 / busy)
    assert like.read("iw_likelihood_device_pct.eval", ctx) == (
        pytest.approx(100.0 * 10 / busy))


def test_without_the_span_the_readers_read_nothing(monkeypatch):
    """A program without the model's spans (the parent of the change that
    adds them) gives None, never 0."""
    recs = [span("model.eval_step", 10, 90, 1)]
    ctx = _ctx(monkeypatch, recs)
    for name in ("iw_decode_device_pct.eval",
                 "iw_likelihood_device_pct.eval"):
        assert cells.metric_reader(name).read(name, ctx) is None


def test_without_device_operations_or_launches_nothing(monkeypatch):
    ctx = _ctx(monkeypatch, RECS, ops=[])
    assert launch_spans.busy_share_pct(ctx, "miwae.decode") is None
    ctx = _ctx(monkeypatch, RECS, launches={})
    assert launch_spans.busy_share_pct(ctx, "miwae.decode") is None


def test_a_cpu_profiler_has_no_device_launches():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    win = Window(False)
    win.prof = prof
    launches, ops = launch_spans.read_launches(win)
    assert launches == {} and ops == []

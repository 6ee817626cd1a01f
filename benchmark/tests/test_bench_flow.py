"""The cell `flow_wine.eval_m50` on the CPU at a small size, and what it
adds to the harness: it resolves to the eval driver and the flow's plain
reference (`reference/flow.py`, which loads nothing of the program) at
M=50; the sound program is correct and the TF32 control and the planted
faults are not; the flow's FLOP count; the readers of `mfu_flow.eval` and
`flow_spline_share.eval` on synthetic windows."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

import run
from counts import flops_flow
from counts.kernels import PEAKS
from harness import cells, launch_spans, spans
from harness.trace import Window
from vae_posterior_consistency_tpu_torch.utils.tracing import Span

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CELL = "flow_wine.eval_m50"
#: a few rows and reps at the published widths (hid_dim 500 is the
#: program's default, which the configuration's widths must match)
SMALL = {"config": {"rows_train": 24, "rows_test": 8},
         "traffic": {"M": 2, "sample_range": 1}}


def _run(variant, seed=2**31 + 30, trace=0, seconds=0.3):
    argv = ["--workload", CELL, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
    if variant:
        argv += ["--variant", variant]
    return run.run(run.parse(argv), device="cpu", overrides=SMALL)


def test_the_cell_resolves_to_its_driver_and_reference():
    c = cells.resolve(CELL)
    assert c.traffic["driver"] == "eval" and c.traffic["M"] == 50
    assert cells.driver(c).__file__ == str(BENCH / "drivers" / "eval.py")
    assert cells.reference(c).__file__ == str(BENCH / "reference"
                                              / "flow.py")
    assert c.config["vae_type"] == "reg_flow1" and c.chips == 1
    # the widths the reference and the count read are the program's
    assert c.config["encoder_trunk"] == [c.config["hid_dim"]] * 2
    assert c.config["decoder"] == [c.config["hid_dim"]] * 4
    assert {m["name"] for m in c.end_to_end} == {"eval_rows_per_s",
                                                 "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        "device_idle_pct.eval", "eval_graph_share.eval", "mfu_flow.eval",
        "flow_spline_share.eval"}


@pytest.mark.parametrize("variant,correct", [
    (None, True), ("tf32", False), ("half_batch", False),
    ("altered", False)], ids=str)
def test_cell_against_reference(variant, correct):
    result, _ = _run(variant)
    assert result["correct"] is correct, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"eval_rows_per_s", "setup_s"}


def test_traced_run_on_the_cpu_reads_the_host_metrics():
    """No device operation on the CPU: the device shares read nothing, the
    host-clock metric is read."""
    result, _ = _run(None, trace=1, seconds=1.0)
    got = result["metrics"]
    assert result["correct"]
    assert got["mfu_flow.eval"]["value"] > 0
    assert "flow_spline_share.eval" not in got
    assert "device_idle_pct.eval" not in got


_REFERENCE = r"""
import sys, json, importlib.util, torch
spec = importlib.util.spec_from_file_location("ref", {path!r})
ref = importlib.util.module_from_spec(spec); spec.loader.exec_module(ref)
cfg = json.load(open({config!r}))
g = torch.Generator().manual_seed(0)
p = {{k: torch.rand(s, generator=g) * 2 * b - b
      for k, s, b in ref.param_specs(cfg)}}
x = torch.rand(20, cfg["obs_dim"], generator=g)
m = (x > 0.5).float()
stats, _ = ref.evaluate_split(p, cfg, x, m, torch.randperm(20),
                              torch.randn(24, cfg["latent_dim"]), 8)
assert torch.isfinite(stats).all()
assert not torch.backends.cuda.matmul.allow_tf32
assert not torch.backends.cudnn.allow_tf32
print(json.dumps(sorted(sys.modules)))
"""


def test_reference_loads_nothing_of_the_program_and_turns_tf32_off():
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE.format(
            path=str(BENCH / "reference" / "flow.py"),
            config=str(BENCH / "configs" / "flow_wine.json"))],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    top = {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}
    assert not top & {"jax", "jaxlib", "flax", "vae_posterior_consistency_tpu",
                      "vae_posterior_consistency_tpu_torch"}


# -- the FLOP count and mfu_flow ----------------------------------------------


def test_flops_of_one_call_at_the_published_size():
    c = cells.resolve(CELL)
    cfg = {**c.config, "M": c.traffic["M"]}
    assert flops_flow.encoder_row(cfg) == 2 * (26 * 500 + 500 * 500
                                               + 500 * 100)
    assert flops_flow.decoder_row(cfg) == 2 * (10 * 500 + 3 * 500 * 500
                                               + 500 * 13)
    assert flops_flow.encoder_row(cfg) + flops_flow.decoder_row(cfg) == (
        2_149_000)
    # 50 reps of 3 batches of 64 and 1 of 17: 10,450 padded rows
    assert flops_flow.eval_call(cfg) == 10_450 * 2_149_000
    assert round(flops_flow.eval_call(cfg) / 1e9, 2) == 22.46


def test_mfu_flow_reads_the_cells_widths():
    reader = cells.metric_reader("mfu_flow.eval")
    got = reader.read("mfu_flow.eval", {"calls": 10, "window_s": 2.0})
    assert got == pytest.approx(100.0 * 10 * 10_450 * 2_149_000
                                / (2.0 * PEAKS["float32_flops_per_s"]))
    assert reader.read("mfu_flow.eval", {"calls": 0, "window_s": 2.0}) is None
    assert reader.read("mfu_flow.eval", {"window_s": 2.0}) is None


# -- flow_spline_share on synthetic windows -----------------------------------

NAME = "flow_spline_share.eval"


def span(name, a, b, id, parent=None, root=None):
    return Span(name, a, b, id, parent, id if root is None else root, 1, {})


#: an eager batch [10, 90]: encode [12, 20], spline [20, 40], decode [40,
#: 60], likelihood [60, 70]; then a replayed batch's model.eval_step [90,
#: 100] that opens no flow span
RECS = [span("flow.encode", 12, 20, 2, parent=1, root=1),
        span("flow.spline", 20, 40, 3, parent=1, root=1),
        span("flow.decode", 40, 60, 4, parent=1, root=1),
        span("flow.likelihood", 60, 70, 5, parent=1, root=1),
        span("model.eval_step", 10, 90, 1),
        span("model.eval_step", 90, 100, 6)]
#: launches (correlation id: host time); the device operations run later
LAUNCHES = {1: 11, 2: 15, 3: 25, 4: 35, 5: 45, 6: 65, 7: 95}
OPS = [(1, 30, 31), (2, 31, 35), (3, 40, 50), (4, 50, 56), (5, 60, 70),
       (6, 70, 72), (7, 100, 140)]


def _ctx(monkeypatch, recs, ops=OPS, launches=LAUNCHES):
    win = Window(False)
    win.host_ops = [("aten::op", 0, 200)]
    win.device_ops = [("kernel", a, b) for _, a, b in ops]
    monkeypatch.setattr(spans, "_program_records", lambda: recs)
    monkeypatch.setattr(launch_spans, "read_launches",
                        lambda w: (launches, ops))
    return {"window": win, "window_s": 2e-7}


def test_the_spline_share_of_the_flow_spans_device_time(monkeypatch):
    """The spline's operations (10 + 6 ns) over those launched in any
    `flow.*` span (4 + 16 + 10 + 2 ns): the operation launched inside
    `model.eval_step` alone (1 ns) and the replay's (40 ns) are not the
    flow model's."""
    got = cells.metric_reader(NAME).read(NAME, _ctx(monkeypatch, RECS))
    assert got == pytest.approx(100.0 * 16 / 32)


@pytest.mark.parametrize("recs", [
    None, [],
    # a program without the flow's spans (the parent of the change that
    # adds them): its model step alone
    [span("model.eval_step", 10, 90, 1), span("model.eval_step", 90, 100,
                                             6)],
    # spans of another model
    [span("miwae.decode", 20, 40, 2, parent=1, root=1),
     span("model.eval_step", 10, 90, 1)]],
    ids=["no_tracer", "nothing_recorded", "no_flow_spans", "other_model"])
def test_nothing_without_flow_spans(recs, monkeypatch):
    assert cells.metric_reader(NAME).read(NAME, _ctx(monkeypatch, recs)) is (
        None)


def test_nothing_without_device_operations_under_the_flow(monkeypatch):
    """Flow spans with no operation launched inside them (every batch
    replayed) read nothing, never 0; neither does a window without device
    operations."""
    assert cells.metric_reader(NAME).read(NAME, _ctx(
        monkeypatch, RECS, ops=[(7, 100, 140)])) is None
    assert cells.metric_reader(NAME).read(NAME, _ctx(
        monkeypatch, RECS, ops=[])) is None

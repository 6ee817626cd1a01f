"""Each cell's driver against the plain reference at a tiny size on the
CPU, through `run.run` with the chip's look skipped: the sound program
passes; the control (the reference with its products' operands rounded to
TF32, put in the program's place) and each fault the cell can have, planted
in the timed path, come out not correct. The faults: a step that returns
its state unchanged, half of the batch left out with the mean over the
rest, an answer altered where it is produced. (One chip, so no exchange
between chips to leave out.)"""

import pytest
import torch

import run
from harness import cells

#: a size a test run holds: the widths as published, fewer rows
SMALL = {
    "eddi_wine.train": {},
    "eddi_wine.al": {"config": {"M": 3}, "traffic": {"sample_range": 2}},
    "eddi_mnist.serve": {"config": {"rows_test": 600},
                         "traffic": {"rate_per_s": 40, "check_requests": 4,
                                     "rows_max": 64}},
    "eddi_mnist.eval": {"config": {"rows_train": 300, "rows_test": 100},
                        "traffic": {"sample_range": 1}},
}
FAULTS = {
    "eddi_wine.train": ("unchanged", "unchanged_in_window", "half_batch"),
    "eddi_wine.al": ("unchanged", "altered"),
    "eddi_mnist.serve": ("altered",),
    "eddi_mnist.eval": ("half_batch", "altered"),
}
CASES = ([(c, None, True) for c in SMALL]
         + [(c, "tf32", False) for c in SMALL]
         + [(c, f, False) for c, fs in FAULTS.items() for f in fs])


def _run(cell, variant, seed=2**31 + 12345, trace=0):
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
            "--trace", str(trace)]
    if variant:
        argv += ["--variant", variant]
    return run.run(run.parse(argv), device="cpu", overrides=SMALL[cell])


@pytest.mark.parametrize("cell,variant,correct", CASES,
                         ids=lambda v: str(v))
def test_cell_against_reference(cell, variant, correct):
    result, lines = _run(cell, variant)
    assert result["correct"] is correct, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert lines[-len(result["checks"]):] == [
        f"check {k}: {c['value']!r} limit {c['limit']!r}"
        for k, c in result["checks"].items()]
    names = {m["name"] for m in cells.resolve(cell).end_to_end}
    assert set(result["metrics"]) == names
    assert all(m["value"] > 0 for m in result["metrics"].values())


def test_traced_run_reads_host_metrics_on_the_cpu():
    """--trace 1 on the CPU: no device operation, so no device metric;
    the host-clock ones are read."""
    result, _ = _run("eddi_wine.train", None, trace=1)
    assert result["correct"]
    assert "device_idle_pct.train" not in result["metrics"]
    assert result["metrics"]["mfu.train"]["value"] > 0
    assert result["metrics"]["adam_host_ms_per_step.train"]["value"] > 0
    assert result["device"]["busy_s"] == 0.0


def test_same_seed_same_inputs():
    a, _ = _run("eddi_wine.train", None, seed=7)
    b, _ = _run("eddi_wine.train", None, seed=7)
    assert a["checks"] == b["checks"]


def test_reference_against_the_port_loss():
    """The reference's loss of one batch equals the port's plain path's."""
    from harness import inputs, program

    cell = cells.resolve("eddi_wine.train")
    ref = cells.reference(cell)
    cfg = cell.config
    g = torch.Generator().manual_seed(3)
    p = inputs.weights(ref.param_specs(cfg), g, "cpu")
    x = torch.rand(64, 13, generator=g)
    mask = (torch.rand(64, 13, generator=g) > 0.3).float()
    u = torch.rand(64, 13, generator=g)
    eps = torch.randn(2, 64, 10, generator=g)
    rc = program.run_config(cfg)
    model = program.model(rc)
    from vae_posterior_consistency_tpu_torch.ops import masks
    _, mask_p = masks.train_masks(rc.info, rc, mask, uniforms=u)
    port, _ = model.train_loss(program.nested(p), x, mask, mask_p, eps,
                               1.0, rc)
    assert float(port) == pytest.approx(
        float(ref.train_loss(p, cfg, x, mask, u, eps)), rel=1e-6)


def test_tf32_round():
    from harness import cells as c
    ref = c.reference(c.resolve("eddi_wine.train"))
    t = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0])
    r = ref.tf32_round(t)
    assert r.tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, -3.0]

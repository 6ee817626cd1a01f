"""`metrics/eval_call_fixed_ms.py`, `idle_under_call_fixed_pct.py` and
`idle_outside_program_pct.py` on a synthetic window: hand-made spans of the
program's evaluator and hand-made device intervals (times in us)."""

import pytest

from harness import cells, spans
from harness.trace import Window
from vae_posterior_consistency_tpu_torch.utils.tracing import Count, Span

FIXED_MS = "eval_call_fixed_ms.eval"
IDLE_FIXED = "idle_under_call_fixed_pct.eval"
OUTSIDE = "idle_outside_program_pct.eval"
READERS = [FIXED_MS, IDLE_FIXED, OUTSIDE]

US = 1000


def span(name, a, b, id, parent=None, root=None, **attrs):
    return Span(name, a * US, b * US, id, parent,
                id if root is None else root, 1, attrs)


def window(busy, host=(0, 2100)):
    win = Window(False)
    win.host_ops = [("aten::op", host[0] * US, host[1] * US)]
    win.device_ops = sorted(("kernel", a * US, b * US) for a, b in busy)
    return win


def read(name, win, recs, monkeypatch, ctx=None):
    monkeypatch.setattr(spans, "_program_records", lambda: recs)
    ctx = {"window": win, "window_s": 1e-3} if ctx is None else ctx
    return cells.metric_reader(name).read(name, ctx)


def graph_call():
    """`eval_vae` [0, 1000]: set-up, a split with its set-up, one rep's
    permutation, a captured batch (draw, warm-up, capture) and a replayed
    one, the read-back, the release. Fixed: 50 + 25 + 50 + 130 + 180 + 90
    = 525 us."""
    return [
        span("eval_vae", 0, 1000, 1),
        span("eval.setup", 10, 60, 2, 1, 1, scope="call"),
        span("eval.split", 70, 900, 3, 1, 1),
        span("eval.setup", 75, 100, 4, 3, 1, scope="split"),
        span("eval.prepare", 100, 150, 5, 3, 1, rep=0),
        span("eval.batch", 150, 500, 6, 3, 1, rows=64),
        span("eval.draw", 155, 170, 7, 6, 1),
        span("eval.warmup", 170, 300, 8, 6, 1),
        span("model.eval_step", 180, 290, 9, 8, 1),
        span("eval.capture", 300, 480, 10, 6, 1),
        span("model.eval_step", 310, 470, 11, 10, 1),
        span("eval.batch", 500, 850, 12, 3, 1, rows=64),
        span("eval.draw", 505, 520, 13, 12, 1),
        span("model.eval_step", 520, 800, 14, 12, 1, graph=1),
        span("eval.stats", 800, 840, 15, 12, 1),
        span("eval.readback", 850, 890, 16, 3, 1),
        Count("host_reads", 880 * US, 1, 1, 16, 1),
        span("eval.release", 900, 990, 17, 1, 1),
    ]


def mnar_call():
    """`eval_vae_mnar` [1100, 1500]: set-up (40 us), one rep."""
    return [
        span("eval_vae_mnar", 1100, 1500, 20),
        span("eval.setup", 1110, 1150, 21, 20, 20, scope="call"),
        span("eval.draw", 1150, 1200, 22, 20, 20),
        span("model.eval_step", 1200, 1400, 23, 20, 20),
        span("eval.readback", 1400, 1490, 24, 20, 20),
    ]


def eager_call():
    """`eval_vae` [1600, 2000] without a graph: set-up 90 us, a split's
    set-up 20 us, no rep; then a call cut by the window's end (its root
    past it), whose set-up lies inside."""
    return [
        span("eval_vae", 1600, 2000, 30),
        span("eval.setup", 1610, 1700, 31, 30, 30, scope="call"),
        span("eval.setup", 1700, 1720, 32, 30, 30, scope="split"),
        span("eval_vae", 2050, 2200, 40),
        span("eval.setup", 2060, 2070, 41, 40, 40, scope="call"),
    ]


RECS = graph_call() + mnar_call() + eager_call()

#: the card busy inside the call's set-up, the warm-up's and the capture's
#: model steps, most of the replay, the MNAR step and the third call's
#: set-up
BUSY = [(20, 40), (200, 250), (320, 460), (540, 800), (1200, 1400),
        (1620, 1690)]

#: idle: [0, 20], [40, 200], [250, 320], [460, 540], [800, 1200],
#: [1400, 1620], [1690, 2100]
IDLE = 20 + 160 + 70 + 80 + 400 + 220 + 410

#: idle under a fixed phase: 10 ([10, 20]), 125 ([40, 60], [75, 150],
#: [170, 200]), 70 ([250, 320]: the warm-up, its model step, the capture),
#: 20 ([460, 480]), 130 (the release [900, 990], the MNAR set-up), 10
#: ([1610, 1620]), 40 ([1690, 1720] and the cut call's set-up)
IDLE_FIXED_US = 10 + 125 + 70 + 20 + 130 + 10 + 40

#: idle under no span: [1000, 1100], [1500, 1600], [2000, 2060],
#: [2070, 2100] (the cut call's root lies past the range: not recorded)
IDLE_OUTSIDE_US = 100 + 100 + 60 + 30


def test_the_per_call_sums_by_root_and_their_median(monkeypatch):
    """The calls' sums are 525, 40 and 110 us; the cut call's set-up is
    counted in none."""
    assert read(FIXED_MS, window(BUSY), RECS, monkeypatch) == (
        pytest.approx(0.110))


def test_the_median_of_an_even_number_of_calls(monkeypatch):
    recs = graph_call() + mnar_call()
    assert read(FIXED_MS, window(BUSY), recs, monkeypatch) == (
        pytest.approx((0.525 + 0.040) / 2))


def test_idle_under_the_fixed_phases(monkeypatch):
    assert read(IDLE_FIXED, window(BUSY), RECS, monkeypatch) == (
        pytest.approx(100 * IDLE_FIXED_US / IDLE))


def test_idle_under_a_model_step_inside_the_warm_up_is_fixed(monkeypatch):
    """The card idle only while the warm-up's `model.eval_step` is
    innermost: all of it is the fixed phases' (and the model's, by the
    innermost label)."""
    recs = [span("eval_vae", 0, 100, 1),
            span("eval.setup", 0, 5, 2, 1, 1, scope="call"),
            span("eval.batch", 10, 90, 3, 1, 1),
            span("eval.warmup", 10, 60, 4, 3, 1),
            span("model.eval_step", 15, 55, 5, 4, 1)]
    win = window([(0, 20), (40, 100)], host=(0, 100))
    ctx = {"window": win, "window_s": 1e-4}
    assert read(IDLE_FIXED, win, recs, monkeypatch, ctx) == 100.0
    name = "idle_under_model_pct.eval"
    assert cells.metric_reader(name).read(name, ctx) == 100.0


def test_idle_outside_every_span(monkeypatch):
    assert read(OUTSIDE, window(BUSY), RECS, monkeypatch) == (
        pytest.approx(100 * IDLE_OUTSIDE_US / IDLE))


def test_fixed_evaluator_model_and_outside_add_up_to_100(monkeypatch):
    """The fixed phases' share, and of the idle time under no fixed phase
    the evaluator's (innermost `eval_vae` or `eval.*`), the model's
    (innermost `model.eval_step`) and no span's, partition the idle time.
    The latter three are read by `idle_by_span` on a window whose card is
    busy besides over every fixed-phase span."""
    fixed = read(IDLE_FIXED, window(BUSY), RECS, monkeypatch)
    outside = read(OUTSIDE, window(BUSY), RECS, monkeypatch)
    phases = [(s.start_ns // US, s.end_ns // US) for s in RECS
              if isinstance(s, Span)
              and s.name in cells.metric_reader(FIXED_MS).FIXED]
    rest = spans.idle_by_span(window(BUSY + phases),
                              spans.in_range(RECS, 0, 2100 * US))
    evaluator = sum(ns for label, ns in rest.items()
                    if label.startswith(("eval_vae", "eval.")))
    model = rest["model.eval_step"]
    assert set(rest) <= {"eval_vae", "eval_vae_mnar", "eval.split",
                         "eval.batch", "eval.draw", "eval.stats",
                         "eval.readback", "model.eval_step", spans.OUTSIDE}
    assert 100 * rest[spans.OUTSIDE] / (IDLE * US) == pytest.approx(outside)
    assert evaluator and model
    assert fixed + outside + 100 * (evaluator + model) / (IDLE * US) == (
        pytest.approx(100.0))


#: an older program's records: the same calls without the phases its root
#: left out or did not name (its `eval.capture` stays), so no `eval.setup`
OLD = [r for r in RECS if not (isinstance(r, Span) and r.name in (
    "eval.setup", "eval.prepare", "eval.warmup", "eval.release"))]


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("recs", [
    None, [], [span("elsewhere", 1, 2, 1)], OLD,
    [span("eval_vae", 0, 500, 1), Count("host_reads", 10, 1, 1, 1, 1)]],
    ids=["no_tracer", "nothing_recorded", "span_absent",
         "without_the_new_spans", "root_only"])
def test_nothing_without_the_new_spans(name, recs, monkeypatch):
    assert read(name, window(BUSY), recs, monkeypatch) is None


@pytest.mark.parametrize("name", [IDLE_FIXED, OUTSIDE])
def test_no_idle_share_without_device_operations(name, monkeypatch):
    assert read(name, window([]), RECS, monkeypatch) is None


def test_the_call_cost_needs_no_device_operation(monkeypatch):
    """A trace of the CPU path (no device operation) still times the
    calls' fixed phases."""
    assert read(FIXED_MS, window([]), RECS, monkeypatch) == (
        pytest.approx(0.110))

"""`harness/spans` and the readers of the program's spans and counters, on a
synthetic window: hand-made device intervals, host operations and spans."""

import pytest

from harness import cells, spans
from harness.trace import Window
from vae_posterior_consistency_tpu_torch.utils.tracing import Count, Span

#: the per-layer metrics read from the program's spans and counters
PROGRAM_METRICS = ["eval_batch_host_us.eval", "idle_under_evaluator_pct.eval",
                   "idle_under_model_pct.eval", "embed_pool_host_us.eval",
                   "host_reads_per_call.eval", "serve_copy_in_us.serve",
                   "al_step_host_us.al"]


def span(name, a, b, id, parent=None, root=None, tid=1, **attrs):
    return Span(name, a, b, id, parent, id if root is None else root, tid,
                attrs)


def window(busy=((10, 20), (50, 60)), host=(0, 100)):
    """A traced window whose host operations span `host` and whose device
    is busy over `busy` (ns)."""
    win = Window(False)
    win.host_ops = [("aten::op", host[0], host[1])]
    win.device_ops = [("kernel", a, b) for a, b in busy]
    return win


def ctx_of(win, recs, monkeypatch):
    monkeypatch.setattr(spans, "_program_records", lambda: recs)
    return {"window": win, "window_s": 1e-7}


#: A [5, 45] with its child B [15, 30], C [48, 70] on its own; the card idle
#: over [0, 10], [20, 50], [60, 100]
RECS = [span("B", 15, 30, 2, parent=1, root=1), span("A", 5, 45, 1),
        span("C", 48, 70, 3)]


def test_idle_parts_sum_to_the_idle_time_and_the_innermost_wins():
    win = window()
    by = spans.idle_by_span(win, spans.in_range(RECS, 0, 100))
    assert sum(by.values()) == 10 + 30 + 40
    # [0,5], [45,48], [70,100] outside; [5,10] and [30,45] under A alone;
    # [20,30] under B, which is inside A; the gap [20,50] straddles B, A,
    # no span and C
    assert dict(by) == {spans.OUTSIDE: 5 + 3 + 30, "A": 5 + 15, "B": 10,
                        "C": 2 + 10}


def test_busy_time_outside_the_recorded_range_is_cut():
    win = window(busy=((-20, 10), (50, 60), (95, 130), (140, 150)))
    by = spans.idle_by_span(win, spans.in_range(RECS, 0, 100))
    assert sum(by.values()) == 40 + 35
    assert by[spans.OUTSIDE] == 3 + 25


def test_threads_tie_to_the_deeper_span():
    """Two threads' spans over one gap: the deeper one holds it, and of two
    as deep the one opened last."""
    recs = [span("inner", 30, 40, 2, parent=1, root=1, tid=1),
            span("outer", 20, 60, 1, tid=1),
            span("other", 25, 45, 3, tid=2)]
    by = spans.idle_by_span(window(busy=((0, 20), (60, 100))),
                            spans.in_range(recs, 0, 100))
    assert dict(by) == {"outer": 5 + 15, "other": 5 + 5, "inner": 10}


def test_self_time_is_less_the_children():
    assert spans.self_ns(RECS) == {1: 40 - 15, 2: 15, 3: 22}


def test_only_records_inside_the_recorded_range_count(monkeypatch):
    recs = RECS + [span("A", 90, 120, 9),
                   Count("host_reads", 50, 1, 1, None, None),
                   Count("host_reads", 101, 1, 1, None, None)]
    ctx = ctx_of(window(), recs, monkeypatch)
    got = spans.records(ctx)
    assert [s.id for s in got.spans] == [2, 1, 3]
    assert [c.t_ns for c in got.counts] == [50]
    assert spans.records(ctx) is got  # kept for the next reader


def test_medians_and_the_per_call_ratio(monkeypatch):
    recs = [span("eval.batch", 10, 11_010, 2, parent=1, root=1, rows=64),
            span("eval.batch", 12_000, 15_000, 3, parent=1, root=1),
            span("eval.batch", 16_000, 16_500, 4, parent=1, root=1),
            span("eval_vae", 5, 20_000, 1),
            span("eval_vae", 21_000, 30_000, 5),
            Count("host_reads", 100, 1, 1, 2, 1),
            Count("host_reads", 19_000, 1, 1, 1, 1),
            Count("host_reads", 29_000, 2, 1, 5, 5),
            Count("host_reads", 31_000, 7, 1, None, None)]
    ctx = ctx_of(window(host=(0, 40_000)), recs, monkeypatch)
    assert spans.median_us(ctx, "eval.batch") == 3.0
    assert spans.per_call(ctx, "host_reads", "eval_vae") == 2.0
    assert cells.metric_reader("eval_batch_host_us.eval").read(
        "eval_batch_host_us.eval", ctx) == 3.0
    assert cells.metric_reader("host_reads_per_call.eval").read(
        "host_reads_per_call.eval", ctx) == 2.0


def test_the_idle_shares_of_the_evaluator_and_the_model(monkeypatch):
    """eval_vae [0, 100] > eval.batch [0, 60] > model.eval_step [10, 50] >
    ops.embed_pool [20, 30]; the card busy over [30, 40] and [55, 90]."""
    recs = [span("ops.embed_pool", 20, 30, 4, parent=3, root=1),
            span("model.eval_step", 10, 50, 3, parent=2, root=1),
            span("eval.batch", 0, 60, 2, parent=1, root=1),
            span("eval_vae", 0, 100, 1)]
    ctx = ctx_of(window(busy=((30, 40), (55, 90)), host=(0, 120)), recs,
                 monkeypatch)
    read = {n: cells.metric_reader(n).read(n, ctx) for n in
            ("idle_under_evaluator_pct.eval", "idle_under_model_pct.eval")}
    idle = 30 + 15 + 30  # [0, 30], [40, 55], [90, 120]
    # the evaluator: [0, 10], [50, 55] (eval.batch), [90, 100] (eval_vae)
    assert read["idle_under_evaluator_pct.eval"] == pytest.approx(
        100 * 25 / idle)
    # the model: [10, 20], [40, 50]
    assert read["idle_under_model_pct.eval"] == pytest.approx(100 * 20 / idle)
    by = ctx["program_idle"]
    assert by["ops.embed_pool"] == 10 and by[spans.OUTSIDE] == 20


@pytest.mark.parametrize("name", PROGRAM_METRICS)
@pytest.mark.parametrize("recs", [None, [], [span("elsewhere", 1, 2, 1)]],
                         ids=["no_tracer", "nothing_recorded",
                              "span_absent"])
def test_nothing_where_the_span_is_absent(name, recs, monkeypatch):
    ctx = ctx_of(window(), recs, monkeypatch)
    assert cells.metric_reader(name).read(name, ctx) is None


@pytest.mark.parametrize("name", [n for n in PROGRAM_METRICS
                                  if "idle_under" in n])
def test_no_idle_share_without_device_operations(name, monkeypatch):
    ctx = ctx_of(window(busy=()), RECS + [span("eval_vae", 0, 99, 7),
                                          span("model.eval_step", 1, 2, 8)],
                 monkeypatch)
    assert cells.metric_reader(name).read(name, ctx) is None

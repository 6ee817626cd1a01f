"""`metrics/flow_fused_share.py` on a synthetic window: hand-made spans and
counter events of the program's flow model under the evaluator."""

import pytest

from harness import cells, spans
from harness.trace import Window
from vae_posterior_consistency_tpu_torch.utils.tracing import Count, Span

NAME = "flow_fused_share.eval"


def span(name, a, b, id, parent=None, root=None):
    return Span(name, a, b, id, parent, id if root is None else root, 1, {})


def read(recs, monkeypatch):
    win = Window(False)
    win.host_ops = [("aten::op", 0, 100_000)]
    win.device_ops = [("kernel", 10, 20)]
    monkeypatch.setattr(spans, "_program_records", lambda: recs)
    ctx = {"window": win, "window_s": 1e-4}
    return cells.metric_reader(NAME).read(NAME, ctx)


def call(call_id, t0, fused, eager, rows=64, root="eval_vae"):
    """A `root` span at `t0` whose eager batches pushed `rows` each through
    the spline stack, the first `fused` through F1, the next `eager`
    without it."""
    out = [span(root, t0, t0 + 10_000, call_id)]
    for i in range(fused + eager):
        sid = call_id * 1000 + i + 1
        out.append(span("flow.spline", t0 + 10 * i + 1, t0 + 10 * i + 9,
                        sid, parent=call_id, root=call_id))
        out.append(Count("flow_rows", t0 + 10 * i + 5, rows, 1, sid,
                         call_id))
        if i < fused:
            out.append(Count("flow_fused_rows", t0 + 10 * i + 5, rows, 1,
                             sid, call_id))
    return out


def test_every_row_through_f1_reads_100(monkeypatch):
    recs = call(1, 0, 4, 0) + call(2, 20_000, 2, 0, rows=17)
    assert read(recs, monkeypatch) == 100.0


def test_the_share_of_rows_over_the_window_calls(monkeypatch):
    recs = (call(1, 0, 1, 1) + call(2, 20_000, 1, 3, rows=17)
            # outside any eval_vae span: not counted
            + [Count("flow_fused_rows", 50_000, 10**6, 1, None, None)]
            # inside another root (an AL episode): not counted
            + call(3, 60_000, 2, 0, root="al.episode"))
    assert read(recs, monkeypatch) == pytest.approx(
        100 * (64 + 17) / (2 * 64 + 4 * 17))


@pytest.mark.parametrize("recs", [
    None, [], [span("elsewhere", 1, 2, 1)],
    # a program without F1: rows through the stack, none counted through it
    call(1, 0, 0, 2),
    # F1's rows under another root only
    call(1, 0, 2, 0, root="serve.impute"),
    # the evaluator without a flow model: neither counter
    [span("eval_vae", 0, 500, 1), Count("host_reads", 10, 1, 1, 1, 1)]],
    ids=["no_tracer", "nothing_recorded", "span_absent", "no_f1",
         "only_elsewhere", "no_flow"])
def test_nothing_without_the_counters(recs, monkeypatch):
    assert read(recs, monkeypatch) is None

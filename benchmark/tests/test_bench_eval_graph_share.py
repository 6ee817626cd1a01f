"""`metrics/eval_graph_share.py` on a synthetic window: hand-made spans and
counter events of the program's evaluator."""

import pytest

from harness import cells, spans
from harness.trace import Window
from vae_posterior_consistency_tpu_torch.utils.tracing import Count, Span

NAME = "eval_graph_share.eval"


def span(name, a, b, id, parent=None, root=None):
    return Span(name, a, b, id, parent, id if root is None else root, 1, {})


def read(recs, monkeypatch):
    win = Window(False)
    win.host_ops = [("aten::op", 0, 100_000)]
    win.device_ops = [("kernel", 10, 20)]
    monkeypatch.setattr(spans, "_program_records", lambda: recs)
    ctx = {"window": win, "window_s": 1e-4}
    return cells.metric_reader(NAME).read(NAME, ctx)


def batches(call_id, t0, eager, replays):
    """An `eval_vae` span at `t0` whose batches ran `eager` eagerly, then
    `replays` from a graph, with the counter events inside them."""
    out = [span("eval_vae", t0, t0 + 10_000, call_id)]
    for i in range(eager + replays):
        bid = call_id * 1000 + i + 1
        out.append(span("eval.batch", t0 + 10 * i + 1, t0 + 10 * i + 9, bid,
                        parent=call_id, root=call_id))
        kind = "eval_eager_batches" if i < eager else "eval_graph_replays"
        out.append(Count(kind, t0 + 10 * i + 5, 1, 1, bid, call_id))
    return out


def test_the_share_of_replayed_batches_over_the_window_calls(monkeypatch):
    recs = (batches(1, 0, 1, 9) + batches(2, 20_000, 1, 29)
            + [Count("eval_graph_captures", 30, 1, 1, 1, 1),
               # outside any eval_vae span: not counted
               Count("eval_eager_batches", 50_000, 5, 1, None, None)])
    assert read(recs, monkeypatch) == pytest.approx(100 * 38 / 40)


def test_every_batch_eager_reads_zero(monkeypatch):
    assert read(batches(1, 0, 12, 0), monkeypatch) == 0.0


@pytest.mark.parametrize("recs", [
    None, [], [span("elsewhere", 1, 2, 1)],
    # a program without the graph path: calls, but neither counter
    [span("eval_vae", 0, 500, 1), Count("host_reads", 10, 1, 1, 1, 1)]],
    ids=["no_tracer", "nothing_recorded", "span_absent", "no_counters"])
def test_nothing_without_the_counters(recs, monkeypatch):
    assert read(recs, monkeypatch) is None

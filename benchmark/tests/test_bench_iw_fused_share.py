"""`metrics/iw_fused_share.py` on a synthetic window: hand-made spans and
counter events of the program's MIWAE model."""

import pytest

from harness import cells, spans
from harness.trace import Window
from vae_posterior_consistency_tpu_torch.utils.tracing import Count, Span

NAME = "iw_fused_share.eval"


def span(name, a, b, id, parent=None, root=None):
    return Span(name, a, b, id, parent, id if root is None else root, 1, {})


def read(recs, monkeypatch):
    win = Window(False)
    win.host_ops = [("aten::op", 0, 100_000)]
    win.device_ops = [("kernel", 10, 20)]
    monkeypatch.setattr(spans, "_program_records", lambda: recs)
    ctx = {"window": win, "window_s": 1e-4}
    return cells.metric_reader(NAME).read(NAME, ctx)


def call(call_id, t0, fused, eager, samples=320_000):
    """An `eval_vae` span at `t0` whose model steps decoded `samples` each,
    the first `fused` through IW1, the next `eager` without it."""
    out = [span("eval_vae", t0, t0 + 10_000, call_id)]
    for i in range(fused + eager):
        sid = call_id * 1000 + i + 1
        out.append(span("model.eval_step", t0 + 10 * i + 1, t0 + 10 * i + 9,
                        sid, parent=call_id, root=call_id))
        out.append(Count("iw_samples", t0 + 10 * i + 5, samples, 1, sid,
                         call_id))
        if i < fused:
            out.append(Count("iw_fused_samples", t0 + 10 * i + 5, samples,
                             1, sid, call_id))
    return out


def test_every_sample_through_iw1_reads_100(monkeypatch):
    recs = call(1, 0, 3, 0) + call(2, 20_000, 1, 0, samples=85_000)
    assert read(recs, monkeypatch) == 100.0


def test_the_share_of_samples_over_the_window_calls(monkeypatch):
    recs = (call(1, 0, 3, 1) + call(2, 20_000, 1, 3)
            # outside any eval_vae span: not counted
            + [Count("iw_fused_samples", 50_000, 10**6, 1, None, None)])
    assert read(recs, monkeypatch) == pytest.approx(100 * 4 / 8)


@pytest.mark.parametrize("recs", [
    None, [], [span("elsewhere", 1, 2, 1)],
    # a program without IW1: samples decoded, none counted through it
    call(1, 0, 0, 4),
    # a family without importance samples: neither counter
    [span("eval_vae", 0, 500, 1), Count("host_reads", 10, 1, 1, 1, 1)]],
    ids=["no_tracer", "nothing_recorded", "span_absent", "no_iw1",
         "no_samples"])
def test_nothing_without_the_counters(recs, monkeypatch):
    assert read(recs, monkeypatch) is None

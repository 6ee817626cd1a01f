"""`metrics/mnar_fused_share.py` on a synthetic window: hand-made spans and
counter events of the program's notMIWAE model under the MNAR evaluator."""

import pytest

from harness import cells, spans
from harness.trace import Window
from vae_posterior_consistency_tpu_torch.utils.tracing import Count, Span

NAME = "mnar_fused_share.eval"


def span(name, a, b, id, parent=None, root=None):
    return Span(name, a, b, id, parent, id if root is None else root, 1, {})


def read(recs, monkeypatch):
    win = Window(False)
    win.host_ops = [("aten::op", 0, 100_000)]
    win.device_ops = [("kernel", 10, 20)]
    monkeypatch.setattr(spans, "_program_records", lambda: recs)
    ctx = {"window": win, "window_s": 1e-4}
    return cells.metric_reader(NAME).read(NAME, ctx)


def call(call_id, t0, fused, eager, samples=1_780_000, root="eval_vae_mnar"):
    """A `root` span at `t0` whose reps decoded `samples` each, the first
    `fused` through IW2, the next `eager` without it."""
    out = [span(root, t0, t0 + 10_000, call_id)]
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


def test_every_sample_through_iw2_reads_100(monkeypatch):
    recs = call(1, 0, 1, 0) + call(2, 20_000, 2, 0, samples=170_000)
    assert read(recs, monkeypatch) == 100.0


def test_the_share_of_samples_over_the_window_calls(monkeypatch):
    recs = (call(1, 0, 1, 1) + call(2, 20_000, 1, 3)
            # outside any eval_vae_mnar span: not counted
            + [Count("iw_fused_samples", 50_000, 10**6, 1, None, None)]
            # inside an eval_vae span (the MIWAE evaluator): not counted
            + call(3, 60_000, 2, 0, root="eval_vae"))
    assert read(recs, monkeypatch) == pytest.approx(100 * 2 / 6)


@pytest.mark.parametrize("recs", [
    None, [], [span("elsewhere", 1, 2, 1)],
    # a program without IW2: samples decoded, none counted through it
    call(1, 0, 0, 2),
    # IW1's samples under eval_vae only
    call(1, 0, 2, 0, root="eval_vae"),
    # the evaluator without importance samples counted: neither counter
    [span("eval_vae_mnar", 0, 500, 1), Count("host_reads", 10, 1, 1, 1, 1)]],
    ids=["no_tracer", "nothing_recorded", "span_absent", "no_iw2",
         "only_iw1", "no_samples"])
def test_nothing_without_the_counters(recs, monkeypatch):
    assert read(recs, monkeypatch) is None

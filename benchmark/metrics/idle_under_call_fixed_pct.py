"""The share of the card's idle time spent in an evaluation call's fixed
phases, in percent: the idle time in the traced window while any
fixed-phase span (`eval_call_fixed_ms.FIXED`) is open, whatever span is
nested inside it (a warm-up's `model.eval_step` counts), over all the idle
time there (`harness/spans.idle_gaps` over the recorded range). Nothing
where the program records no `eval.setup` or the trace holds no device
operation."""

from harness import cells, spans

_calls = cells.metric_reader("eval_call_fixed_ms.eval")


def _union(intervals):
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(name, ctx):
    win = ctx["window"]
    phases = _calls.phase_spans(ctx)
    if phases is None or not win.device_ops:
        return None
    recs = spans.records(ctx)
    gaps = spans.idle_gaps(win, recs.lo, recs.hi)
    total = sum(b - a for a, b in gaps)
    if not total:
        return None
    open_ = _union((s.start_ns, s.end_ns) for s in phases)
    under, j = 0, 0
    for a, b in gaps:  # both lists sorted and disjoint
        while j < len(open_) and open_[j][1] <= a:
            j += 1
        k = j
        while k < len(open_) and open_[k][0] < b:
            under += min(b, open_[k][1]) - max(a, open_[k][0])
            k += 1
    return 100.0 * under / total

"""The share of the card's idle time while no span of the program is open,
in percent: `harness/spans.OUTSIDE` in `spans.idle_by_span`, over all the
idle time in the traced window. With every host line of an evaluation call
inside its root span, this is the caller's own loop between calls (in the
benchmark: its noise source and result checks). Nothing where the program
records no `eval.setup` (a program whose root span leaves the call's
set-up out, so that set-up would read as the caller's) or the trace holds
no device operation."""

from harness import cells, spans

_calls = cells.metric_reader("eval_call_fixed_ms.eval")


def read(name, ctx):
    win = ctx["window"]
    if _calls.phase_spans(ctx) is None or not win.device_ops:
        return None
    if "program_idle" not in ctx:
        ctx["program_idle"] = spans.idle_by_span(win, spans.records(ctx))
    by = ctx["program_idle"]
    total = sum(by.values())
    if not total:
        return None
    return 100.0 * by[spans.OUTSIDE] / total

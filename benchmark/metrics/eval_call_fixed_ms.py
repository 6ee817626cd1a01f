"""An evaluation call's fixed host cost, in ms: for each call in the traced
window (a root span `eval_vae` or `eval_vae_mnar` of `engine/evaluate`),
the summed durations of its fixed-phase spans (`FIXED`, matched by the
root id the tracer records), which do not nest in one another; the median
of those sums over the calls. The phases are the call's work that does not
scale with its batches: set-up, each rep's permutation, the warm-up and
capture of a graph, the release. Nothing where the program records no
`eval.setup` (a program whose root span leaves the call's set-up out)."""

import statistics

from harness import spans

#: the spans of an evaluation call's fixed phases
FIXED = ("eval.setup", "eval.prepare", "eval.warmup", "eval.capture",
         "eval.release")

#: the root span of an evaluation call
CALLS = ("eval_vae", "eval_vae_mnar")


def phase_spans(ctx):
    """The window's fixed-phase spans; None where it holds no
    `eval.setup`."""
    recs = spans.records(ctx)
    if recs is None:
        return None
    out = [s for s in recs.spans if s.name in FIXED]
    if not any(s.name == "eval.setup" for s in out):
        return None
    return out


def read(name, ctx):
    phases = phase_spans(ctx)
    if phases is None:
        return None
    sums = {s.id: 0 for s in spans.records(ctx).spans if s.name in CALLS}
    for s in phases:
        if s.root in sums:
            sums[s.root] += s.end_ns - s.start_ns
    if not sums:
        return None
    return statistics.median(sums.values()) / 1e6

"""The spline's share of the flow model's device time, in percent: the
device time of the operations launched while `flow.spline` was the
innermost program span (the three spline layers of `nn/flow`), over that
of the operations launched while any of the flow model's spans was
innermost (the context encoder, the spline, the decoder, the likelihood's
sums; `harness/launch_spans`).

On the card the evaluator replays a captured graph for most batches, and
a replay opens no model span (its graph launches under
`model.eval_step`), so this reads the eagerly run batches: each
`eval_vae` call's warm-up batch of each batch shape, which run the same
kernels. Nothing where the program records no flow span, or where no
device operation was launched inside one."""

from harness import launch_spans

SPANS = ("flow.spline", "flow.encode", "flow.decode", "flow.likelihood")


def read(name, ctx):
    shares = {s: launch_spans.busy_share_pct(ctx, s) for s in SPANS}
    model = sum(v for v in shares.values() if v)
    if not model:
        return None
    return 100.0 * (shares["flow.spline"] or 0.0) / model

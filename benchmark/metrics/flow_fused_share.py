"""The share of the flow model's spline rows that went through F1
(`ops/fused_flow`, one kernel for the three spline layers of
`nn/flow.flow_forward`), in percent: 100 x the program's `flow_fused_rows`
counter over its `flow_rows`, both inside the window's `eval_vae` spans (by
their root id). The program counts both on the batches it runs eagerly (a
replayed graph runs no Python), which run the same path. Nothing where the
program records no such span, no `flow_rows` or no `flow_fused_rows` (a
program without F1)."""

from harness import spans


def read(name, ctx):
    fused = spans.per_call(ctx, "flow_fused_rows", "eval_vae")
    total = spans.per_call(ctx, "flow_rows", "eval_vae")
    if not fused or not total:
        return None
    return 100.0 * fused / total

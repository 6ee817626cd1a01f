"""The share of the importance-weighted evaluator's decoder samples that
went through IW1 (`ops/fused_iw`, one kernel for z, the Student-t decoder,
its log-density and their sums), in percent: 100 x the program's
`iw_fused_samples` counter over its `iw_samples`, both inside the window's
`eval_vae` spans (by their root id). Nothing where the program records no
such span, no `iw_samples` or no `iw_fused_samples` (a program without
IW1)."""

from harness import spans


def read(name, ctx):
    fused = spans.per_call(ctx, "iw_fused_samples", "eval_vae")
    total = spans.per_call(ctx, "iw_samples", "eval_vae")
    if not fused or not total:
        return None
    return 100.0 * fused / total

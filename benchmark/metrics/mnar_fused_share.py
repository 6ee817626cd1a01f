"""The share of the MNAR evaluator's decoder samples that went through IW2
(`ops/fused_iw_mnar`, one kernel for notMIWAE's encoder, z, the decoder,
the per-sample terms with the self-masking log-pmf, and the reductions over
K), in percent: 100 x the program's `iw_fused_samples` counter over its
`iw_samples`, both inside the window's `eval_vae_mnar` spans (by their root
id). Nothing where the program records no such span, no `iw_samples` or no
`iw_fused_samples` (a program without IW2)."""

from harness import spans


def read(name, ctx):
    fused = spans.per_call(ctx, "iw_fused_samples", "eval_vae_mnar")
    total = spans.per_call(ctx, "iw_samples", "eval_vae_mnar")
    if not fused or not total:
        return None
    return 100.0 * fused / total

"""The evaluator's own share of the card's idle time, in percent: the idle
time in the traced window whose innermost open span is the evaluator's
(`eval_vae` or an `eval.*` span of `engine/evaluate`: its slicing, draws,
reductions and read-back, not the model or a kernel wrapper inside it),
over all the idle time there (`harness/spans.idle_by_span`). Nothing where
the program records no spans."""

from harness import spans


def read(name, ctx):
    return spans.idle_share_pct(ctx, "eval_vae", "eval.")

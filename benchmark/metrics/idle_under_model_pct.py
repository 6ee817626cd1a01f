"""The model's share of the card's idle time, in percent: the idle time in
the traced window whose innermost open span is `model.eval_step` (the
dense layers and everything of the model but a kernel wrapper's own host
side), over all the idle time there (`harness/spans.idle_by_span`).
Nothing where the program records no spans."""

from harness import spans


def read(name, ctx):
    return spans.idle_share_pct(ctx, "model.eval_step")

"""The missingness model's share of the card's busy time, in percent: the
device operations launched while `notmiwae.missingness` was the innermost
program span (the mixed rows, the self-masking logits and the Bernoulli
log-pmf of the mask over rows x K samples, `models/notmiwae._branch`),
over the card's busy time in the traced window (`harness/launch_spans`).
Nothing where the program records no such span."""

from harness import launch_spans


def read(name, ctx):
    return launch_spans.busy_share_pct(ctx, "notmiwae.missingness")

"""The likelihood's share of the card's busy time, in percent: the device
operations launched while `miwae.likelihood` was the innermost program
span (the Student-t log-density over B x K x D, its masked sums, log p(z)
and log q, `models/miwae._branch_terms`), over the card's busy time in the
traced window (`harness/launch_spans`). Nothing where the program records
no such span."""

from harness import launch_spans


def read(name, ctx):
    return launch_spans.busy_share_pct(ctx, "miwae.likelihood")

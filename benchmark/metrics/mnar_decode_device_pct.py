"""The not-MIWAE decoder's share of the card's busy time, in percent: the
device operations launched while `notmiwae.decode` was the innermost
program span (the reparameterised z and the decoder's trunk and heads
over rows x K samples, `models/notmiwae.forward`), over the card's busy
time in the traced window (`harness/launch_spans`). Nothing where the
program records no such span."""

from harness import launch_spans


def read(name, ctx):
    return launch_spans.busy_share_pct(ctx, "notmiwae.decode")

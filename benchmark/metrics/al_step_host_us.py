"""The AL engine's host time a selection step, in us: the median duration
of the program's `al.step` spans (`engine/active_learning.al_step`: the M
imputations, the rewards, the reveal and the predictive MSE, as
dispatched) in the traced window. Nothing where the program records no
such span."""

from harness import spans


def read(name, ctx):
    return spans.median_us(ctx, "al.step")

"""The evaluator's host time a batch, in us: the median duration of the
program's `eval.batch` spans (`engine/evaluate._split_metrics`: the batch's
slicing, draws, `eval_step` and statistics, as dispatched) in the traced
window. Nothing where the program records no such span."""

from harness import spans


def read(name, ctx):
    return spans.median_us(ctx, "eval.batch")

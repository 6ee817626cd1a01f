"""Host reads an evaluation call makes: the program's `host_reads` counter
events inside its `eval_vae` spans (by their root id), over the number of
those spans in the traced window. Nothing where the program records no
such span."""

from harness import spans


def read(name, ctx):
    return spans.per_call(ctx, "host_reads", "eval_vae")

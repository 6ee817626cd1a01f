"""B2f's host side, in us: the median duration of the program's
`ops.embed_pool` spans (`ops/fused_embed_pool.embed_pool`: checks,
layout, allocation and the launch) in the traced window. Nothing where the
program records no such span."""

from harness import spans


def read(name, ctx):
    return spans.median_us(ctx, "ops.embed_pool")

"""B2f and B2b (`csrc/embed_pool.cu`) against their roofline, in percent:
the least time of every launch the window's work made (`counts/kernels`,
at the shapes the driver called them with) over the two kernels' device
time in the trace. Nothing where the trace holds neither kernel."""

from counts import kernels


def read(name, ctx):
    return kernels.roofline_pct(ctx, ("embed_pool_fwd", "embed_pool_bwd"))

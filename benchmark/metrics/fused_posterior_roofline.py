"""B1 and its backward (`csrc/fused_posterior.cu`) against their roofline,
in percent, read as `embed_pool_roofline` reads B2f and B2b."""

from counts import kernels


def read(name, ctx):
    return kernels.roofline_pct(ctx, ("fused_posterior_fwd",
                                      "fused_posterior_bwd"))

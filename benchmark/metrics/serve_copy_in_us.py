"""The server's copy in, in us: the median duration of the program's
`serve.copy_in` spans (`engine/serve.ImputationServer.impute`: the pad
and the host-to-device copies of a request) in the traced window. Nothing
where the program records no such span."""

from harness import spans


def read(name, ctx):
    return spans.median_us(ctx, "serve.copy_in")

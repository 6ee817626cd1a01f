"""Device operations (kernels, copies, fills) a training step puts on the
card: those in the trace over the steps traced."""


def read(name, ctx):
    steps = ctx.get("steps")
    n = ctx["window"].count_device()
    if not steps or not n:
        return None
    return n / steps

"""Host time of torch's Adam step a training step, in ms: the profiler's
`Optimizer.step#Adam.step` ranges over the steps traced."""


def read(name, ctx):
    steps = ctx.get("steps")
    s = ctx["window"].host_seconds("Optimizer.step#Adam.step")
    if not steps or not s:
        return None
    return 1e3 * s / steps

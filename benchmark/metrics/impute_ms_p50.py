"""The median host time of an `ImputationServer.impute` call over the
window's requests, in ms (it returns numpy, so the device work is
done)."""

import statistics


def read(name, ctx):
    times = ctx.get("impute_ms")
    return statistics.median(times) if times else None

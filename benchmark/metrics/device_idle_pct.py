"""The card's idle share of the traced window, in percent: 100 x (1 -
union of the device operations' intervals / window)."""


def read(name, ctx):
    win = ctx["window"]
    if not win.device_ops:
        return None
    return 100.0 * (1.0 - win.busy_s() / ctx["window_s"])

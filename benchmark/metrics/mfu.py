"""The whole window's share of the card's float32 peak, in percent: the
model FLOPs the window's work needs (`counts/flops.py`, from the
configuration's widths) over window seconds x the H100's float32 rate
outside the tensor cores (`counts/peaks.json`; the port's dense layers run
float32 with TF32 off)."""

from counts.kernels import PEAKS


def read(name, ctx):
    if not ctx.get("flops"):
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"]
                                   * PEAKS["float32_flops_per_s"])

"""The flow-posterior VAE's evaluation share of the card's float32 peak, in
percent: the window's `eval_vae` calls times the FLOPs of one call
(`counts/flops_flow.py`: the context encoder and the decoder once a
wrap-padded row a rep; the spline flow and other elementwise work not
counted) over window seconds x the H100's float32 rate outside the tensor
cores (`counts/peaks.json`; TF32 is off). The widths are those of the
configuration of the cell that this metric's entry lists, by name
(`harness/cells`); M is its traffic's."""

from counts import flops_flow
from counts.kernels import PEAKS
from harness import cells


def _config(name):
    (entry,) = [m for m in cells.load_all()["per_layer"]
                if m["name"] == name]
    (cell,) = entry["workloads"]
    c = cells.resolve(cell)
    return {**c.config, "M": c.traffic["M"]}


def read(name, ctx):
    if not ctx.get("calls"):
        return None
    flops = ctx["calls"] * flops_flow.eval_call(_config(name))
    return 100.0 * flops / (ctx["window_s"] * PEAKS["float32_flops_per_s"])

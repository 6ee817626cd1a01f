"""The MNAR evaluator's share of the card's float32 peak, in percent: the
window's FLOPs (the driver's `eval_vae_mnar` calls times one call's,
`counts/flops_mnar.py`: the encoder a row, the decoder and the imputation
a sample, at valid_k samples a row; elementwise work not counted) over
window seconds x the H100's float32 rate outside the tensor cores
(`counts/peaks.json`; TF32 is off): the whole step's share."""

from counts.kernels import PEAKS


def read(name, ctx):
    if not ctx.get("calls") or not ctx.get("flops"):
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"]
                                   * PEAKS["float32_flops_per_s"])

"""step_mfu.train: the whole train step's share of the card's bf16 peak, in %.

Model FLOPs of the traced units of work (portbench/flops.py: attention in
every layer, no remat recomputation) over the traced window's wall time
and 989 TFLOP/s. Nothing for another kind of cell.
"""

from portbench.flops import PEAK_BF16_FLOPS


def read(ctx):
    if ctx.kind != "train" or ctx.trace.window_s <= 0:
        return None
    return 100.0 * ctx.units * ctx.model_flops / (ctx.trace.window_s * PEAK_BF16_FLOPS)

"""other_ms_per_step.train: device milliseconds a train step outside the GEMMs
and the attention kernels: elementwise work, norms, the loss, AdamW, copies.
Nothing for another kind of cell, or without device events.
"""

from portbench import trace


def read(ctx):
    if ctx.kind != "train" or not ctx.trace.device:
        return None
    named = ctx.kernels["matmul"]["patterns"] + ctx.kernels["attention"]["patterns"]
    return 1e3 * trace.device_seconds(ctx.trace, exclude=named) / ctx.units

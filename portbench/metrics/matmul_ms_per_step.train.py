"""matmul_ms_per_step.train: device milliseconds a train step in the GEMM
kernels (the name patterns of portbench/kernels/matmul.json, the attention
kernels' excluded). Nothing for another kind of cell, or without them.
"""

from portbench import trace


def read(ctx):
    if ctx.kind != "train":
        return None
    seconds = trace.device_seconds(ctx.trace, ctx.kernels["matmul"]["patterns"],
                                   exclude=ctx.kernels["attention"]["patterns"])
    return 1e3 * seconds / ctx.units if seconds > 0 else None

"""attn_roofline.train: the attention kernels' (K1's) share of their roofline, in %.

For every forward, dK/dV and dQ launch over the traced window (the port's
launch counters), the least time the card could take for that call at the
cell's shape (portbench/flops.py attention_bounds), summed, over the device
time of the kernels named in portbench/kernels/attention.json. Nothing when
no attention kernel ran, or for another kind of cell.
"""

from portbench import flops, trace


def read(ctx):
    if ctx.kind != "train":
        return None
    spec = ctx.kernels["attention"]
    n = ctx.launches.get("attention", {})
    seconds = trace.device_seconds(ctx.trace, spec["patterns"])
    if seconds <= 0 or not any(n.values()):
        return None
    bounds = getattr(flops, spec["count"])(flops.widths(ctx.cell.config), ctx.attention_rows,
                                           ctx.seq_len)
    least = sum(n[name] * bounds[name]["seconds"] for name in n)
    return 100.0 * least / seconds

"""device_idle_share.train: the share of the traced window in which no
operation ran on the card, in %: 1 − (union of the device events ÷ window).
Nothing for another kind of cell, or without device events.
"""

from portbench import trace


def read(ctx):
    if ctx.kind != "train" or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s(ctx.trace) / ctx.trace.window_s)

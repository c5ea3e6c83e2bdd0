"""traced_samples_per_s.train_p95: rows trained a second over the traced
window (the traced steps, folds × rows a fold each, over the window's wall
on the host's clock, the card synchronized at both ends), in the train
cells whose end-to-end rate is left out because it follows the host.
Nothing for another kind of cell.
"""


def read(ctx):
    if ctx.kind != "train" or ctx.trace.window_s <= 0:
        return None
    t = ctx.cell.traffic
    return ctx.units * int(t["folds"]) * int(t["rows_per_fold"]) / ctx.trace.window_s

"""device_idle.serve: the share of the traced sub-window (a run of whole
batches of the window) in which no device activity ran, in percent."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)

"""The share of the traced slice in which no operation ran on the device:
1 - (union of the device activity intervals) / (the slice's wall time)."""


def read(ctx):
    s = ctx.slice
    return None if s is None or s.window_s <= 0 else 100.0 * (1.0 - s.busy_s / s.window_s)

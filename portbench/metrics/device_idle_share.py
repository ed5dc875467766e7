"""The share of the traced slice's wall time in which no operation ran on
the device: 1 - (union of the device-busy intervals) / wall."""


def read(ctx):
    s = ctx.slice
    if s.wall_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.wall_s)

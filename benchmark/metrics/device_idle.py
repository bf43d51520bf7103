"""The device's idle share of the profiled slice, in percent: 1 minus the
union of its kernel, copy and set intervals over the slice's length."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

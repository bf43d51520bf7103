"""The whole step's share of the card's peak, in percent: the least time
of the window's work by the traffic kind's count of a call (its
``call_least``, one call per 16 steps), over the window's wall time.  Read
from the measured window, before the profiler starts."""


def read(ctx):
    w = ctx.window
    least = ctx.kind.call_least(ctx.config, ctx.traffic, ctx.graph)
    return 100.0 * least * w["steps"] / ctx.counts.CALL_STEPS / w["seconds"]

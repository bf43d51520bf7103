"""The 95th percentile (nearest rank) of every request's latency in the
window, from the call to its readout on the host, in milliseconds."""

import math


def read(ctx):
    xs = sorted(ctx.window["latencies"])
    return 1e3 * xs[max(0, math.ceil(0.95 * len(xs)) - 1)]

"""The plasticity kernel's share of its roofline, in percent: the least
time of its R-STDP calls' work (`counts.lp_call_least`, one call per 16
steps) over the device time of its kernel records in the profiled slice
(``lp_step_kernel`` and the per-step design's kernels)."""

KERNELS = ("lp_step_kernel", "lp_cell_kernel", "lp_edge_kernel",
           "lp_dopamine_kernel")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    secs = sum(d for name, d in t.kernels
               if any(k in name for k in KERNELS))
    if secs <= 0:
        return None
    g = ctx.graph
    least = ctx.counts.lp_call_least(*g.shape, g.offsets, g.masked_slots)
    return 100.0 * least * t.steps / ctx.counts.CALL_STEPS / secs

"""The stencil kernel's share of its roofline, in percent: the least time
of its calls' work (`counts.stencil_call_least`, one call per 16 steps)
over the device time of its kernel records in the profiled slice (any of
its three designs)."""

KERNELS = ("model_persistent_kernel", "izh_tiled_kernel",
           "izh_stencil_step_kernel")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    secs = sum(d for name, d in t.kernels
               if any(k in name for k in KERNELS))
    if secs <= 0:
        return None
    g = ctx.graph
    least = ctx.counts.stencil_call_least(*g.shape, g.offsets)
    return 100.0 * least * t.steps / ctx.counts.CALL_STEPS / secs

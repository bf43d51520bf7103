"""Device microseconds per closed-loop step of every kernel other than the
plasticity kernel's (the callbacks' reductions, selects and copies) in the
profiled slice."""

PLASTICITY = ("lp_step_kernel", "lp_cell_kernel", "lp_edge_kernel",
              "lp_dopamine_kernel")


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels:
        return None
    secs = sum(d for name, d in t.kernels
               if not any(k in name for k in PLASTICITY))
    return 1e6 * secs / t.steps

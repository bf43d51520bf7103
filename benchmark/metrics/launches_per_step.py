"""CUDA kernel launches per simulated step in the window, as the port's C
entries count them (every ``STEP_LAUNCHES`` and ``ENV_LAUNCHES`` counter of
its kernel modules, read before and after the window)."""


def read(ctx):
    n = sum(v for k, v in ctx.counters.items()
            if k.endswith(".STEP_LAUNCHES") or k.endswith(".ENV_LAUNCHES"))
    return n / ctx.window["steps"] if n else None

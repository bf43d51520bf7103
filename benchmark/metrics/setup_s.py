"""Seconds from the start of the process to the first timed request:
imports, the CUDA context, the kernel library (built by the first run in
a checkout), the system's construction and the warm-up request."""


def read(ctx):
    return ctx.window["setup_s"]

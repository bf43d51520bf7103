"""Lattice neurons times the steps completed in the window, over the
window's wall time (it ends on a synchronise)."""


def read(ctx):
    w = ctx.window
    return ctx.neurons * w["steps"] / w["seconds"]

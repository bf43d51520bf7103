"""Microseconds of the host a kernel call takes: the median duration of
the port's ``*.call`` spans (``stencil.call``, ``plasticity.call``: one
wrapper call of 16 steps, its checks, buffers, launch arguments and C call)
and of the closed loop's ``loop.step`` outside a replay (the callbacks and
the one-step entry), as entry calls open them (`snnbench.spans`)."""

from snnbench import spans


def read(ctx):
    took = [(s.end_ns - s.start_ns) * 1e-3
            for entry, calls in spans.entry_calls(spans.record())
            for s in spans.direct_calls(entry, calls)
            if s.name != "loop.replay"]
    return spans.median(took)

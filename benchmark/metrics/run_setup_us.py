"""Microseconds from an entry call's start (``*.run``: ``lattice.run``,
``reward.run``, ``loop.run``) to its first kernel call (``*.call``:
``stencil.call``, ``plasticity.call``; the closed loop's first
``loop.replay`` or ``loop.step``): each run's set-up on the host, median
over the entry calls of the port's span record (`snnbench.spans`)."""

from snnbench import spans


def read(ctx):
    gaps = []
    for entry, calls in spans.entry_calls(spans.record()):
        first = spans.direct_calls(entry, calls)
        if first:
            gaps.append((first[0].start_ns - entry.start_ns) * 1e-3)
    return spans.median(gaps)

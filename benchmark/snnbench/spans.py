"""The port's own spans, as the per-layer readers read them.

The port records a span for each part of its run paths while a profiler
records (``utils/profiling.py``: `span`, `record`): an entry call (a span
with no parent named ``*.run``: ``lattice.run``, ``reward.run``,
``loop.run``) and, inside it, its set-up, its kernel calls (``*.call``: a
kernel wrapper's call, such as ``stencil.call`` or ``plasticity.call``; the
closed loop's ``loop.replay`` and ``loop.step``) and its waits on the
device.  The names are matched by their form, so a kernel wrapper or an
entry that the port adds is read without an edit here.  A traced run's
profiled slices turn the spans on: the device-only slice (``trace_requests``
requests, with the unread profile before it; the CPU profiler off, so the
host's times are not doubled by it, though CUPTI's tracing and the spans'
annotations still add to them) and the host slice (a quarter as many).
The readers take medians over entry calls or over calls, which fall in
the device-only slice.  A program without the record reads None.
"""

from __future__ import annotations

import statistics
import sys

PROFILING = "spiking_neural_networks_tpu_torch.utils.profiling"
# one call of the closed loop: a graph replay or a step outside it
LOOP_CALLS = ("loop.replay", "loop.step")


def record():
    """The spans the port has recorded in this process (its `Span`
    tuples: id, call, parent, name, start_ns, end_ns), or [] where the
    port has no record."""
    mod = sys.modules.get(PROFILING)
    get = getattr(mod, "record", None)
    return list(get()) if callable(get) else []


def entry_calls(spans):
    """[(entry span, [the spans of its call])] of every entry call whose
    entry span is in ``spans``, in order."""
    by_call = {}
    for s in spans:
        by_call.setdefault(s.call, []).append(s)
    out = []
    for s in spans:
        if s.parent is None and s.name.endswith(".run"):
            out.append((s, sorted(by_call[s.id], key=lambda x: x.id)))
    return out


def direct_calls(entry, spans):
    """The calls (``*.call``, `LOOP_CALLS`) of an entry call opened by the
    entry itself (not the closed loop's probe or capture), in order."""
    return [s for s in spans if s.parent == entry.id
            and (s.name.endswith(".call") or s.name in LOOP_CALLS)]


def median(values):
    return float(statistics.median(values)) if values else None

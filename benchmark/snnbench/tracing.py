"""The profiled slices of a traced run and what is read from them.

After the measured window a traced run profiles more requests with
``torch.profiler`` in two slices.  The first records the device alone
(CUPTI's kernel, copy and set records, which cost the host little): the
kernels by name, the union of the device's busy intervals, and the slice's
length on the host clock between two synchronises.  The second also
records the host, with the benchmark's own spans around each request's
reset, run and readout (``record_function``), and names each idle gap of
the device by the innermost host span it falls in.  The Chrome trace of
each goes through a temporary directory and is read back.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 96


class Slice(NamedTuple):
    """What the profiled slices read: ``kernels`` [(name, seconds)] of
    every device kernel record of the first slice, ``busy_s`` the union of
    its kernel, copy and set intervals, ``window_s`` its length, ``steps``
    and ``requests`` the work it covered, ``device_ops`` [[name, seconds]]
    the device operations that took most time in it, ``idle_gaps`` [[host
    span, seconds]] the device's idle time in the second slice under each
    host span, longest first."""
    kernels: list
    busy_s: float
    window_s: float
    steps: int
    requests: int
    device_ops: list
    idle_gaps: list


def short(name):
    """A device operation's name without its return type and argument
    list (the first "(" outside template brackets that does not follow
    "::"), cut to `NAME_CHARS` characters."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and name[i - 1] != ":":
            name = name[:i]
            break
    return name.rstrip()[:NAME_CHARS]


def union(intervals, lo=float("-inf"), hi=float("inf")):
    """Merged [start, end] intervals clipped to [lo, hi]."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def events_of(trace_events):
    """(device [(start, end, name, cat)], spans [(start, end, name)]) of
    Chrome trace events, in microseconds."""
    device, spans = [], []
    for ev in trace_events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, ev.get("name", cat), cat))
        elif cat == "user_annotation":
            spans.append((ts, ts + dur, ev.get("name", "")))
    return device, spans


def _innermost(spans, t):
    """The names of the host spans that hold time ``t``, outermost first
    ("request/run"), or "outside"."""
    hold = sorted((sp for sp in spans if sp[0] <= t < sp[1]),
                  key=lambda sp: sp[0] - sp[1])
    return "/".join(sp[2] for sp in hold) or "outside"


def rank(totals, top=10):
    return [[k, v] for k, v in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:top]]


def device_reading(device):
    """(kernels, busy seconds, device_ops) of a slice's device records."""
    kernels = [(name, (e - s) * 1e-6) for s, e, name, cat in device
               if cat == "kernel"]
    by_name = {}
    for s, e, name, _ in device:
        key = short(name)
        by_name[key] = by_name.get(key, 0.0) + (e - s) * 1e-6
    busy = union([(s, e) for s, e, _, _ in device])
    return kernels, sum(e - s for s, e in busy) * 1e-6, rank(by_name)


def idle_gaps(device, spans):
    """The device's idle time between the first request span's start and
    the last one's end, summed under the innermost host span at each
    gap's start."""
    reqs = [sp for sp in spans if sp[2] == "request"]
    if not reqs:
        return []
    lo, hi = min(sp[0] for sp in reqs), max(sp[1] for sp in reqs)
    gaps, t = {}, lo
    for s, e in union([(s, e) for s, e, _, _ in device], lo, hi) + [[hi, hi]]:
        if s > t:
            key = _innermost(spans, t)
            gaps[key] = gaps.get(key, 0.0) + (s - t) * 1e-6
        t = max(t, e)
    return rank(gaps)


def _events(prof):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])


def profile(runner, draws, requests, launches, tries=3):
    """Profile ``requests`` requests of ``runner`` (initial voltages from
    ``draws``) on the device, then a quarter as many with the host's spans,
    and read both.  ``launches()`` gives the kernel launches the program's
    C entries have counted so far: a device slice that kept fewer kernel
    records than they counted lost records and is taken again, up to
    ``tries`` times.  Returns the `Slice`, or None where no device slice
    kept its records."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_of
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dev_acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    # a first, unread profile starts the profiler's machinery
    with prof_of(activities=dev_acts):
        runner.request(draws.next())
    got = None
    for _ in range(tries):
        before = launches()
        with prof_of(activities=dev_acts) as prof:
            sync()
            t0 = time.perf_counter()
            for _ in range(requests):
                runner.request(draws.next())
            sync()
            window_s = time.perf_counter() - t0
        counted = launches() - before
        device, _ = events_of(_events(prof))
        kernels, busy_s, ops = device_reading(device)
        if len(kernels) >= counted:
            got = (kernels, busy_s, window_s, ops)
            break
    if got is None:
        return None
    runner.tracing = True
    try:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with prof_of(activities=acts) as prof:
            for _ in range(max(2, requests // 4)):
                runner.request(draws.next())
            sync()
    finally:
        runner.tracing = False
    gaps = idle_gaps(*events_of(_events(prof)))
    kernels, busy_s, window_s, ops = got
    return Slice(kernels, busy_s, window_s, requests * runner.steps,
                 requests, ops, gaps)

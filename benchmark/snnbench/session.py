"""One run of one cell: set-up and warm-up, the measured window, the
profiled slice of a traced run, the check, and the result line.

The cell's traffic kind draws the run's inputs from the seed and builds
the runner that serves its requests.  The window runs them back to back for ``seconds`` (the
request that crosses the end finishes inside it); each request ends with
its readout on the host, so the window ends on a synchronise.  While it
runs, a reservoir drawn from the seed keeps the inputs and the outputs of
``check_requests`` of its requests; after the window closes, the memory
peak is read and the program's state freed, the reference recomputes each
kept request and `check` compares them.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import check, counts, inputs, tracing
from .catalog import ROOT

PORT = "spiking_neural_networks_tpu_torch"
# top-level module names that no run may load (the JAX package, JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "spiking_neural_networks_tpu")


def forbidden_modules():
    """The loaded modules whose top-level name is in `FORBIDDEN`."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def import_port(root=ROOT):
    """The port's package from the checkout ``root`` (nowhere else)."""
    if root not in sys.path:
        sys.path.insert(0, root)
    import importlib
    snt = importlib.import_module(PORT)
    where = os.path.dirname(os.path.abspath(snt.__file__))
    if os.path.dirname(where) != os.path.abspath(root):
        raise ImportError(f"{PORT} was imported from {where}, not from the "
                          f"checkout {root}")
    return snt


def launch_counters(snt):
    """The C entries' counters of the port's kernel modules that are loaded:
    {"module.NAME": count} for every int named ``*LAUNCHES``."""
    out = {}
    prefix = f"{PORT}.ops."
    for name, mod in list(sys.modules.items()):
        if not name.startswith(prefix) or mod is None:
            continue
        for attr, val in vars(mod).items():
            if attr.endswith("LAUNCHES") and type(val) is int:
                out[f"{name[len(prefix):]}.{attr}"] = val
    return out


def kernel_launches(snt):
    """Kernel launches the C entries counted so far (``STEP_LAUNCHES`` and
    ``ENV_LAUNCHES``)."""
    return sum(v for k, v in launch_counters(snt).items()
               if k.endswith(".STEP_LAUNCHES") or k.endswith(".ENV_LAUNCHES"))


class Reservoir:
    """A uniform sample of ``size`` requests of a stream of unknown length
    (Algorithm R), its choices drawn from ``seed``: `take(i)` says before
    request i whether to keep it, `put` keeps it."""

    def __init__(self, size, seed):
        self.size = int(size)
        self.rng = np.random.default_rng(inputs.sub_seed(seed, "sample"))
        self.items, self.slot = [], None

    def take(self, i):
        if i < self.size:
            self.slot = i
        else:
            j = int(self.rng.integers(0, i + 1))
            self.slot = j if j < self.size else None
        return self.slot is not None

    def put(self, item):
        if self.slot == len(self.items):
            self.items.append(item)
        else:
            self.items[self.slot] = item


def finite(readout):
    vals = []
    for x in readout.values():
        vals.extend(x if isinstance(x, list) else [x])
    return all(math.isfinite(x) for x in vals)


def run(cell, seed, seconds, trace, device, t0, log=print, root=ROOT):
    """One run of ``cell`` (a `catalog.Cell`); ``t0`` the process's start on
    ``time.perf_counter``; the port is imported from the checkout
    ``root``.  Returns the result line's object, whose last
    key ``checks`` holds the compared numbers, each beside its limit."""
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    snt = import_port(root)
    t_import = time.perf_counter()
    graph, draws = cell.kind.inputs(cfg, traffic, seed, dev)
    runner = cell.kind.Runner(snt, cfg, traffic, graph, dev)
    if cuda:
        torch.cuda.synchronize()
    t_system = time.perf_counter()
    for _ in range(int(traffic.get("warmup_requests", 1))):
        runner.request(draws.next())
        runner.snapshot()
    if cuda:
        torch.cuda.synchronize()

    keep = Reservoir(traffic["check_requests"], seed)
    counters0 = launch_counters(snt)
    lat, failed, route_ok = [], 0, True
    start = time.perf_counter()
    setup_s = start - t0
    while True:
        x = draws.next()
        kept = keep.take(len(lat))
        if kept:
            x_copy = x.clone()
        t = time.perf_counter()
        got = runner.request(x)
        end = time.perf_counter()
        lat.append(end - t)
        failed += not finite(got)
        route_ok = route_ok and runner.route_ok()
        if kept:
            keep.put((x_copy, runner.snapshot()))
        if end - start >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - start
    counters1 = launch_counters(snt)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    n_req = len(lat)
    neurons = runner.neurons
    window = {"seconds": window_s, "requests": n_req,
              "steps": n_req * runner.steps, "latencies": lat,
              "setup_s": setup_s}

    sliced = None
    if trace:
        sliced = tracing.profile(runner, draws,
                                 int(traffic.get("trace_requests", 10)),
                                 lambda: kernel_launches(snt))

    # the program's state goes before the reference runs
    del runner
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rows_cmp = []
    for x, prog in keep.items:
        ref = cell.trial(cfg, traffic, graph, x)
        rows_cmp.append(check.compare(cell, prog, ref, graph.mask))
    ok, checks = check.verdict(check.merge(rows_cmp), check.limits_of(cell))
    if not route_ok:
        log("the window's requests did not all take the kernel route "
            "the configuration is benchmarked on")
    correct = ok and route_ok and failed == 0

    deltas = {k: counters1.get(k, 0) - counters0.get(k, 0)
              for k in counters1}
    # what a metric's reader reads (`catalog.Metric.read`)
    ctx = SimpleNamespace(cell=cell, config=cfg, traffic=traffic,
                          kind=cell.kind, graph=graph, neurons=neurons,
                          window=window, counters=deltas, trace=sliced,
                          counts=counts)
    metrics = {}
    for m in cell.metrics:
        if m.end_to_end == bool(trace):
            continue
        value = m.read(ctx)
        if value is None:
            if m.end_to_end:
                raise RuntimeError(f"the end-to-end metric {m.name} read "
                                   f"nothing")
            continue
        metrics[m.name] = {"value": value, "unit": m.unit}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": n_req, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace and sliced is not None:
        device_info["busy_s"] = sliced.busy_s
        device_info["window_s"] = sliced.window_s
        result["breakdown"] = {"device_ops": sliced.device_ops,
                               "idle_gaps": sliced.idle_gaps}
    result["checks"] = checks
    build = getattr(sys.modules.get(f"{PORT}._build"), "build_seconds", None)
    log(f"set-up: port imported at {t_import - t0:.4f} s, system built "
        f"{t_system - t_import:.4f} s, warm-up {start - t_system:.4f} s"
        + (f" (nvcc {build:.4f} s)" if build else ""))
    log(f"window: {n_req} requests in {window_s:.4f} s, request ms median "
        f"{1e3 * float(np.median(lat)):.4f}; "
        f"set-up {setup_s:.4f} s; sample of {len(keep.items)} requests "
        f"checked")
    return result

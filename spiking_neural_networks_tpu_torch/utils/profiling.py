"""Step timers and profiler traces.

PyTorch counterpart of ``spiking_neural_networks_tpu/utils/profiling.py``:
wall-clock step rates of any runnable (a lattice or a network), and a thin
wrapper over ``torch.profiler`` that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


class StepTimer:
    """Measures the steady-state steps/s and neuron-updates/s of a
    runnable (`Lattice.run_lattice`, `LatticeNetwork.run_lattices`).  On
    the card each measured run ends with `torch.cuda.synchronize` on the
    state's device, so the time holds the device's work; on the CPU
    nothing is waited for."""

    def __init__(self, obj):
        self.obj = obj
        self.results = {}

    def _leaf(self):
        if hasattr(self.obj, "lattices"):
            members = list(self.obj.lattices.values()) + list(
                getattr(self.obj, "reward_modulated_lattices", {}).values())
            return members[0].state["v"]
        return self.obj.state["v"]

    def _run(self, iterations):
        if hasattr(self.obj, "run_lattices"):
            self.obj.run_lattices(iterations)
        else:
            self.obj.run_lattice(iterations)
        leaf = self._leaf()
        if leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)

    def neurons(self):
        """The neurons a step updates: every lattice's, reward lattice's
        and spike train's."""
        if not hasattr(self.obj, "lattices"):
            return self.obj.n
        return (sum(l.n for l in self.obj.lattices.values())
                + sum(l.n for l in getattr(self.obj,
                                           "reward_modulated_lattices",
                                           {}).values())
                + sum(s.n for s in self.obj.spike_train_lattices.values()))

    def measure(self, iterations=1000, warmup=True):
        if iterations <= 0:
            raise ValueError("iterations must be positive")
        if warmup:
            self._run(iterations)
        t0 = time.perf_counter()
        self._run(iterations)
        dt = time.perf_counter() - t0
        self.results = {
            "seconds": dt,
            "steps_per_sec": iterations / dt,
            "step_time_us": dt / iterations * 1e6,
            "neuron_updates_per_sec": self.neurons() * iterations / dt,
        }
        return self.results


class Trace:
    """What `trace` yields: ``log_dir``, the running ``profile``
    (`torch.profiler.profile`) and, after the block, ``path``, the Chrome
    trace file written into ``log_dir``."""

    def __init__(self, log_dir):
        self.log_dir = log_dir
        self.profile = None
        self.path = None


@contextlib.contextmanager
def trace(log_dir=None):
    """Profile a block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write a Chrome trace (view it in
    chrome://tracing or Perfetto) into ``log_dir``, by default a folder in
    the temporary directory."""
    from torch.profiler import ProfilerActivity, profile
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "snn-torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    out = Trace(log_dir)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        out.profile = prof
        yield out
        if cuda:
            torch.cuda.synchronize()
    out.path = os.path.join(log_dir, f"trace-{os.getpid()}-"
                                     f"{time.time_ns()}.json")
    prof.export_chrome_trace(out.path)

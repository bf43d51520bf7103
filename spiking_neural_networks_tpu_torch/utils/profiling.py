"""Step timers, profiler traces and the port's spans.

PyTorch counterpart of ``spiking_neural_networks_tpu/utils/profiling.py``:
wall-clock step rates of any runnable (a lattice or a network), and a thin
wrapper over ``torch.profiler`` that writes a Chrome trace.

Spans
-----
`span` marks a part of the port's run paths by name.  A span is on while a
``torch.profiler`` session records (any activities), or inside
`recording()`; off, it costs one flag test and enters nothing.  On, it
appends one `Span` to a bounded in-memory record (`RECORD_SPANS`, the
oldest dropped first; `record()`, `clear()`), and under a profiler it also
opens a ``record_function`` of its name, so the span lands in the
profiler's Chrome trace as a ``user_annotation`` on the clock of the
device's kernel, copy and set records.  To see the spans:

* in a Chrome trace: run the code inside `trace()` or any
  ``torch.profiler.profile`` with CPU activity, and open the trace file
  (chrome://tracing or Perfetto);
* without a profiler: ``with recording(): ...``, then `record()`; a span's
  self time (`self_ns`) is its duration less what its children cover.

A span opened with no span open is an entry call: it and every span
opened inside it share its ``call`` id.  The names:

==================== ========================================================
``lattice.run``      entry: `Lattice.run_lattice`
``reward.run``       entry: `RewardModulatedLattice`'s runs
``loop.run``         entry: `interactable.JitEnvironment`'s runs
``lattice.route``    the lattice's route: the neurotransmitter gate and
                     `Lattice._kernel_route`
``stencil.setup``    `ops.stencil_kernels.StencilRun`'s construction: checks,
                     route and plan, library check, the run's buffer sets
``reward.setup``     a reward run's set-up before its first kernel call: its
                     spec and dopamine, then `reward_kernels.advance`'s head
                     (the views, the clones of the weights and traces)
``loop.begin``       a closed-loop call's tier, loop and load, with the
                     children ``loop.load`` (the state into the loop's
                     buffers), ``loop.probe`` (the warm-up step that decides
                     whether the callbacks can be captured) and
                     ``loop.capture`` (the CUDA graph's capture)
``stencil.call``     one call of the stencil kernel's wrapper (16 steps)
``plasticity.call``  one call of the plasticity kernel's wrapper
                     (`reward_kernels.lattice_plasticity_steps`)
``loop.replay``      one replay of the closed loop's CUDA graph (16 steps
                     and a flush)
``loop.step``        one step of the closed loop outside a replay: the
                     callbacks and the one-step entry (also while captured
                     and in the probe)
``loop.flush``       the closed loop's flush: the last step's edge pass
``loop.finish``      a closed-loop call's end: the state handed back, one
                     pull of rewards, dopamine and clock
``wait.<what>``      the host waits for the device: ``wait.nt_mask`` (the
                     neurotransmitter gate), ``wait.uniform_scalars`` (the
                     tiled design's uniform check), ``wait.dopamine`` (a
                     reward run's dopamine to the host), ``wait.loop_pull``
                     (the closed loop's pull)
``build.compile``    nvcc building the kernel library or generated sources
==================== ========================================================

No span synchronises with the device or allocates on it, so spans run in
the closed loop's probe (host syncs turned into errors) and inside a CUDA
graph's capture.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import threading
import time
from typing import NamedTuple, Optional

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


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

# The most spans the record keeps (a 512 x 512 run of 2048 steps makes
# about 130; a closed-loop call of 150 steps about 25).
RECORD_SPANS = 50_000


class Span(NamedTuple):
    """One closed span: ``id`` in the order spans opened, ``call`` the id
    of the entry call (the outermost span open when it opened; its own id
    for an entry call), ``parent`` the id of the span it opened in (None
    for an entry call), ``name``, and its start and end on
    `time.perf_counter_ns`."""
    id: int
    call: int
    parent: Optional[int]
    name: str
    start_ns: int
    end_ns: int


_record = collections.deque(maxlen=RECORD_SPANS)
_recording = 0
_ids = itertools.count(1)
# torch's own flag of a running profiler session (any activities), a
# module global: the cheapest test of it
_profiler = torch.autograd.profiler
# a record_function of a name opened and closed through torch's C entries:
# the same user_annotation in the trace as the Python class, at a fraction
# of its cost
_annotate = torch._C._autograd._record_function_with_args_enter
_annotated = torch._C._autograd._record_function_with_args_exit


class _Open(threading.local):
    def __init__(self):
        self.stack = []          # (id, call) of the open spans, innermost last


_open = _Open()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "ann", "id", "call", "parent", "start")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.ann = _annotate(self.name) \
            if _profiler._is_profiler_enabled else None
        stack = _open.stack
        self.id = next(_ids)
        if stack:
            self.parent, self.call = stack[-1]
        else:
            self.parent, self.call = None, self.id
        stack.append((self.id, self.call))
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _open.stack.pop()
        _record.append(Span(self.id, self.call, self.parent, self.name,
                            self.start, end))
        if self.ann is not None:
            _annotated(self.ann)
        return False


def span(name):
    """A context manager that marks a part of a run by ``name`` (module
    docstring): on while a profiler records or inside `recording()`, else
    a shared no-op."""
    if _recording or _profiler._is_profiler_enabled:
        return _On(name)
    return _OFF


@contextlib.contextmanager
def recording():
    """Turn the spans on for a block, with no profiler: each closed span
    goes into the record (`record()`)."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def record():
    """The spans of the record, in the order they opened."""
    return sorted(_record, key=lambda s: s.id)


def clear():
    """Empty the record."""
    _record.clear()


def self_ns(spans):
    """{id: self time in ns} of ``spans``: each span's duration less the
    durations of its children among ``spans``."""
    out = {s.id: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent in out:
            out[s.parent] -= s.end_ns - s.start_ns
    return out

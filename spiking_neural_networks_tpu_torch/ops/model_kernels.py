"""The elementwise-model stencil kernel: table, gate, wrapper and plain twin.

PyTorch/CUDA counterpart of the generic-model kernel of
``spiking_neural_networks_tpu/ops/pallas_stencil.py``
(`fused_model_multistep`), which traces any elementwise model's
``step(s, i, skip_nt=True)`` into a K-step stencil kernel.  Here a static
table names each model's kernel fields and the fields its step writes,
and ``csrc/model_stencil.cu`` holds one device functor per model that
repeats the model's own PyTorch step.  A neuron of the DSL
(``dsl/builder.py``) takes the DSL arm: `dsl_kernels` generates its functor
from its step, with its layout, and builds it into a library of its own
at first use (`kernel_library`); both run the designs of
``csrc/model_stencil.cuh``.

Two designs of the CUDA kernel: the persistent one (one cooperative launch
per 16-step call, a block's weights and as many parameter planes as fit
in its shared memory, the state in registers) where `persistent_plan`
holds the weights, and the per-step one (a launch a step) elsewhere
(`uses_persistent`).  `ModelRun` makes the checks, the plan, the output
buffers and the launch arguments once for a run of calls on one lattice
(`core.lattice.Lattice._run_model`); `model_steps` is one call of a fresh
`ModelRun`.  On CPU tensors both run the plain twin
`model_steps_reference`, which runs the port model's own ``step`` on
(rows, cols) planes with `KERNEL_FNS`, the float-op exp, tanh and cosh
the kernel computes, so the kernel route on the card equals the same
route on the CPU bit for bit.  A build or launch failure raises; nothing
falls back.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.plasticity import (kernel_cos, kernel_cosh, kernel_exp,
                               kernel_ln, kernel_log10, kernel_pow_nan,
                               kernel_sin, kernel_sinh, kernel_sqrt,
                               kernel_tan, kernel_tanh)
from ..models.base import Fns
from . import dsl_kernels
from ..models.dopa import DopaIzhikevich
from ..models import integrate_and_fire as iaf
from ..models.morris_lecar import MorrisLecar

MAX_OFFSETS = 64          # MS_MAX_OFFSETS in the CUDA source
MAX_FIELDS = 32           # MS_MAX_FIELDS
THREADS = 1024            # MS_THREADS: a persistent block's threads
MAX_CPT = 4               # MS_MAX_CPT: cells a persistent thread
STEPS_PER_LAUNCH = 16     # K of the lattice runner's kernel calls (MS_CHUNK)
# shared memory a persistent block may take (an H100's opt-in maximum)
SMEM_BUDGET = 232448
# the float-op functions of the kernels (log, pow, sinh, log10, sqrt, sin,
# cos and tan: the DSL arm's)
KERNEL_FNS = Fns(kernel_exp, kernel_tanh, kernel_cosh, kernel_ln,
                 kernel_pow_nan, kernel_sinh, kernel_log10, kernel_sqrt,
                 kernel_sin, kernel_cos, kernel_tan)

# Calls of the model kernel (`model_steps`, `ModelRun.steps`) that launched
# CUDA kernels.
LAUNCHES = 0
# The CUDA kernel launches those calls made, as the C entries count them at
# each launch (`call_launches` per call).
STEP_LAUNCHES = 0

# The models the kernel computes: their kind in the CUDA source (MS_* in
# ``csrc/model_stencil.cu``; BCMIzhikevich with chemical_normalization is
# the kind after it), the fields their step writes, in field order, and
# the fields it never reads.  The plain `Izhikevich` is not here: the
# stencil kernel (`stencil_kernels.supports`) takes every lattice of it
# that this kernel would.
_TABLE = {
    iaf.LeakyIntegrateAndFire: (0, ("v", "refractory_count", "is_spiking"),
                                ("v_init", "c_m", "is_spiking")),
    iaf.QuadraticIntegrateAndFire: (1, ("v", "refractory_count",
                                        "is_spiking"),
                                    ("v_init", "c_m", "is_spiking")),
    iaf.AdaptiveLeakyIntegrateAndFire: (2, ("v", "refractory_count", "w",
                                            "is_spiking"),
                                        ("v_init", "w_init", "is_spiking")),
    iaf.AdaptiveExpLeakyIntegrateAndFire: (3, ("v", "refractory_count", "w",
                                               "is_spiking"),
                                           ("v_init", "w_init",
                                            "is_spiking")),
    DopaIzhikevich: (4, ("v", "w", "is_spiking"), ("is_spiking",)),
    iaf.LeakyIzhikevich: (5, ("v", "w", "is_spiking"),
                          ("v_init", "w_init", "is_spiking")),
    iaf.BCMIzhikevich: (6, ("v", "w", "average_activity", "current_activity",
                            "firing_rate_clock", "num_spikes",
                            "is_spiking"), ("v_init", "w_init")),
    iaf.SimpleLeakyIntegrateAndFire: (8, ("v", "is_spiking"),
                                      ("v_init", "c_m", "is_spiking")),
    MorrisLecar: (9, ("v", "ca$m_ss", "ca$current", "kss$n", "kss$n_ss",
                      "kss$t_n", "kss$current", "leak$current",
                      "was_increasing", "is_spiking"),
                  ("v_init", "ca$m_ss", "ca$current", "kss$n_ss", "kss$t_n",
                   "kss$current", "leak$current", "is_spiking")),
}
# the CUDA source's field codes: type, + 4 where the step writes it, + 8
# where it reads it
_CODES = {torch.float32: 0, torch.bool: 1, torch.int32: 2}
_CARRIED, _READ = 4, 8
# the (library, kind) layouts and the libraries whose limits were checked
_layouts_checked = set()
_limits_checked = set()


def kernel_fields(cls):
    """The ((name, dtype), ...) planes of a model class: float fields, bool
    fields, int fields, then ``is_spiking``."""
    return tuple((k, torch.float32) for k in cls.FIELDS) \
        + tuple((k, torch.bool) for k in cls.BOOL_FIELDS) \
        + tuple((k, torch.int32) for k in cls.INT_FIELDS) \
        + (("is_spiking", torch.bool),)


def model_kernel_fields(model):
    """``(fields, carry)``: ``fields`` the ((name, dtype), ...) planes the
    kernel takes (float fields, bool fields, int fields, then
    ``is_spiking``), ``carry`` the names the step writes, in field order;
    None for a model outside the table and for a DSL neuron that the
    emitter does not take (`dsl_kernels.layout`)."""
    if dsl_kernels.is_generated(model):
        lay = dsl_kernels.layout(model)
        return None if lay is None else (lay.fields, lay.carry)
    entry = _TABLE.get(type(model))
    if entry is None:
        return None
    return kernel_fields(type(model)), entry[1]


def model_read_fields(model):
    """The names of the kernel fields the model's step reads, in field
    order (the others it writes only, or ignores)."""
    if dsl_kernels.is_generated(model):
        return dsl_kernels.layout(model).reads
    unread = _TABLE[type(model)][2]
    return tuple(k for k, _ in model_kernel_fields(model)[0]
                 if k not in unread)


def kind(model):
    """The model's kind in the CUDA source (`dsl_kernels.DSL_KIND` in a
    generated one)."""
    if dsl_kernels.is_generated(model):
        return dsl_kernels.DSL_KIND
    k = _TABLE[type(model)][0]
    return k + 1 if getattr(model, "chemical_normalization", False) else k


def supports_model(model, graph, electrical, chemical, do_plasticity):
    """Whether the kernel computes this lattice configuration's step: a
    model of the table, or a DSL neuron that the emitter takes (at most
    `MAX_FIELDS` fields of one type each), with an elementwise step, a
    `StencilGraph` of at most `MAX_OFFSETS` offsets, electrical synapses
    only, no plasticity."""
    from .graph import StencilGraph
    known = dsl_kernels.layout(model) is not None \
        if dsl_kernels.is_generated(model) else type(model) in _TABLE
    return (known
            and getattr(model, "ELEMENTWISE_STEP", False)
            and {"v", "dt", "gap_conductance"} <= set(model.FIELDS)
            and isinstance(graph, StencilGraph)
            and len(graph.offsets) <= MAX_OFFSETS
            and electrical and not chemical and not do_plasticity)


def _check(model, planes, lft, weights, in_deg, offsets, clock0, n_steps):
    fk = model_kernel_fields(model)
    if fk is None:
        raise ValueError(f"no kernel for model {type(model).__name__}")
    shape, dev = lft.shape, lft.device
    if len(shape) != 2:
        raise ValueError(f"lft must be a (rows, cols) plane, got "
                         f"{tuple(shape)}")
    expect = dict(fk[0], last_firing_time=torch.int32, in_deg=torch.float32)
    given = dict(planes, last_firing_time=lft, in_deg=in_deg)
    missing = [k for k in expect if k not in given]
    if missing:
        raise KeyError(f"missing field planes: {missing}")
    for name, dtype in expect.items():
        t = given[name]
        if t.dtype != dtype or t.shape != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {dtype} {tuple(shape)} tensor "
                f"on {dev}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    n_off = len(offsets)
    if weights.dtype != torch.float32 or weights.shape != (n_off, *shape) \
            or weights.device != dev or not weights.is_contiguous():
        raise ValueError(f"weights must be a contiguous float32 "
                         f"{(n_off, *shape)} tensor on {dev}")
    if n_off > MAX_OFFSETS:
        raise ValueError(f"the kernel takes at most {MAX_OFFSETS} offsets, "
                         f"got {n_off}")
    check_clock(clock0, n_steps)
    return fk


def check_layout(lib, k, fields, carry, reads, what):
    """Raise unless the CUDA library's limits are this module's and its
    layout of kind ``k`` is that of ``fields`` ((name, dtype), ...): the
    field count, their types, those the step writes (``carry``) and those
    it reads (``reads``); ``what`` names the kind.  A generated library's
    layout is so held against the emitter's."""
    name = getattr(lib, "_name", None)
    if name not in _limits_checked:
        got = (ctypes.c_int * 5)()
        lib.model_stencil_limits(got)
        want = [MAX_OFFSETS, MAX_FIELDS, THREADS, MAX_CPT, STEPS_PER_LAUNCH]
        if list(got) != want:
            raise RuntimeError(f"the CUDA source's limits {list(got)} differ "
                               f"from the wrapper's {want}")
        _limits_checked.add(name)
    if (name, k) in _layouts_checked:
        return
    codes = (ctypes.c_int * MAX_FIELDS)()
    n = lib.model_stencil_layout(k, codes)
    want = [_CODES[dt] + (_CARRIED if name in carry else 0)
            + (_READ if name in reads else 0) for name, dt in fields]
    if n != len(fields) or list(codes[:n]) != want:
        raise RuntimeError(
            f"the CUDA layout of {what} (kind {k}: "
            f"{list(codes[:max(n, 0)])}) differs from the table's {want}")
    _layouts_checked.add((name, k))


def kernel_library(model):
    """The CUDA library that holds ``model``'s kernel: the package's, or
    for a DSL neuron its generated one (built by nvcc at first use)."""
    if dsl_kernels.is_generated(model):
        return dsl_kernels.load(model)
    from .. import _build
    return _build.load()


def in_fields(model):
    """The fields the step only reads (its parameters), in field order:
    what the persistent design holds in shared memory where it can."""
    fields, carry = model_kernel_fields(model)
    reads = model_read_fields(model)
    return tuple(k for k, dt in fields
                 if dt == torch.float32 and k in reads and k not in carry)


def max_cpt(model):
    """The most cells a persistent thread takes for ``model``: `MAX_CPT`
    where its step keeps at most 4 fields in registers (those it reads and
    writes), else 2 (``ms_max_cpt`` in the CUDA source: BCMIzhikevich's 7
    spilled at 4 cells a thread; a DSL neuron's by its generated layout,
    and at most `dsl_kernels.TRIG_MAX_CPT` where it calls sin, cos or
    tan)."""
    _, carry = model_kernel_fields(model)
    reads = model_read_fields(model)
    cpt = MAX_CPT if sum(k in reads for k in carry) <= 4 else 2
    cap = dsl_kernels.max_cpt(model) \
        if dsl_kernels.is_generated(model) else None
    return cpt if cap is None else min(cpt, cap)


class MsPlan(NamedTuple):
    """Where the persistent design keeps a lattice's values: ``blocks``
    blocks of ``cap`` cells each (a multiple of 32, at most `max_cpt` x
    `THREADS`), ``resident`` the IN fields each block holds in shared
    memory (after the weights, wsum and max(in_deg, 1): ``smem`` bytes a
    block), ``streamed`` the IN fields read from global memory each
    step."""
    blocks: int
    cap: int
    resident: tuple
    streamed: tuple
    smem: int


def persistent_plan(model, shape, n_off, n_blocks, budget=SMEM_BUDGET):
    """The persistent design's plan for ``model`` on a ``shape`` lattice
    of ``n_off`` stencil offsets on a card of ``n_blocks`` SMs (a block
    each), with ``budget`` bytes of shared memory a block: each block
    owns ``cap`` consecutive cells; the shared memory takes the n_off
    weight planes, wsum and max(in_deg, 1) first, then as many IN planes
    as fit, in field order.  None where a block's cells outnumber its
    threads' `max_cpt` or the weights do not fit."""
    return plan_cells(shape, n_off, n_blocks, in_fields(model),
                      max_cpt(model), budget)


def plan_cells(shape, n_off, n_blocks, ins, cpt_max, budget=SMEM_BUDGET):
    """`persistent_plan` for a kind whose IN fields are ``ins`` (in field
    order) and whose threads take at most ``cpt_max`` cells; also the plan
    of the stencil kernel's persistent design
    (`stencil_kernels.persistent_plan`)."""
    n = int(shape[0]) * int(shape[1])
    cap = 32 * -(-(-(-n // int(n_blocks))) // 32)
    base = 4 * cap * (int(n_off) + 2)
    if cap > cpt_max * THREADS or base > budget:
        return None
    fit = min(len(ins), (budget - base) // (4 * cap))
    return MsPlan(-(-n // cap), cap, tuple(ins[:fit]), tuple(ins[fit:]),
                  base + 4 * cap * fit)


def uses_persistent(model, shape, n_off, n_blocks):
    """Whether the runners take the persistent design for ``model`` on a
    ``shape`` lattice of ``n_off`` offsets (`persistent_plan` holds the
    weights; else the per-step design)."""
    return persistent_plan(model, shape, n_off, n_blocks) is not None


def call_launches(n_steps, persistent):
    """The CUDA kernel launches of one call of ``n_steps`` steps: one per
    `STEPS_PER_LAUNCH` steps in the persistent design, one a step in the
    per-step design."""
    n = int(n_steps)
    return -(-n // STEPS_PER_LAUNCH) if persistent else n


def sm_count(dev):
    """The SMs of CUDA device ``dev``: the persistent designs' blocks."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def next_sets(cur, writes):
    """``(a, out)`` of a call that writes the buffer sets ``writes`` times
    (a launch each) when set ``cur`` holds its inputs (None: the caller's
    planes): ``a`` the set it writes first, the one that does not hold
    the inputs, and ``out`` the set it ends on, the writes alternating from
    ``a``."""
    a = 1 if cur == 0 else 0
    return a, (a if writes % 2 else 1 - a)


def check_clock(clock0, n_steps):
    """Raise unless a call of ``n_steps`` steps from ``clock0`` is one the
    kernels take (at least one step, the clock within int32)."""
    if int(n_steps) < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if not -2**31 <= int(clock0) <= 2**31 - int(n_steps):
        raise ValueError(f"clock {clock0} + {n_steps} steps overflows int32")


class RunSets:
    """The state of one run of a stencil-family kernel between its calls
    (`ModelRun`, `stencil_kernels.StencilRun`), and the launch of its C
    entries.

    On CUDA tensors the state lives in two buffer sets of the ``carry``
    fields and lft: a call writes first the set that does not hold its
    inputs (`next_sets`), and its outputs, views into the set it ends on,
    are valid until the next call.  The launch arguments of kind ``kind``
    over ``fields`` ((name, dtype), ...; a field missing from ``planes``,
    which the kind never reads, is passed as NULL) are made once, with the
    persistent design's where ``plan`` (an `MsPlan`) is given, for the C
    entries of ``lib`` (default: the package's library).  On CPU tensors
    it holds the last call's outputs (`keep`), the twin's own tensors."""

    def __init__(self, kind, fields, carry, planes, lft, weights, in_deg,
                 offsets, plan=None, lib=None):
        self.kind, self.fields, self.carry, self.plan = (kind, fields, carry,
                                                         plan)
        self.lft, self.weights, self.in_deg = lft, weights, in_deg
        self.offsets = offsets
        self.cur = None           # the set holding the state; None: inputs
        self.state = (planes, lft)        # on CPU tensors
        self.lib = None
        dev = lft.device
        if dev.type != "cuda":
            return
        if lib is None:
            from .. import _build
            lib = _build.load()
        self.lib = lib
        rows, cols = lft.shape
        new = lambda dtype: torch.empty((2, rows, cols), dtype=dtype,
                                        device=dev)
        self.bufs = {k: new(dt) for k, dt in fields if k in carry}
        self.lft_buf = new(torch.int32)
        ptr = lambda t: None if t is None else t.data_ptr()
        ptrs = ctypes.c_void_p * len(fields)
        # the inputs of a call from the caller's planes (None) or a set
        self.in_ptrs = {
            cur: ptrs(*[ptr(planes.get(k) if cur is None or k not in carry
                            else self.bufs[k][cur]) for k, _ in fields])
            for cur in (None, 0, 1)}
        self.out_ptrs = [ptrs(*[self.bufs[k][b].data_ptr()
                                if k in carry else None for k, _ in fields])
                         for b in (0, 1)]
        self.lft_ptrs = {None: lft.data_ptr(), 0: self.lft_buf[0].data_ptr(),
                         1: self.lft_buf[1].data_ptr()}
        n_off = len(offsets)
        self.dr = (ctypes.c_int * max(n_off, 1))(*[o[0] for o in offsets])
        self.dc = (ctypes.c_int * max(n_off, 1))(*[o[1] for o in offsets])
        if plan is not None:
            # the two planes of v the neighbours read
            self.vbuf = new(torch.float32)
            slot = {k: j for j, k in enumerate(plan.resident)}
            self.slots = (ctypes.c_int * len(fields))(
                *[slot.get(k, -1) for k, _ in fields])

    def keep(self, carried, lft):
        """On CPU tensors: hold a call's outputs as the next call's
        inputs."""
        self.state = (dict(self.state[0], **carried), lft)

    def head(self, a):
        """The arguments both model-kernel entries start with, for a call
        that writes set ``a`` first."""
        return (self.kind, self.in_ptrs[self.cur], len(self.fields),
                self.out_ptrs[a], self.out_ptrs[1 - a],
                self.lft_ptrs[self.cur], self.lft_ptrs[a],
                self.lft_ptrs[1 - a])

    def tail(self, clock0, n_steps):
        """The stencil and grid arguments every entry takes."""
        rows, cols = self.lft.shape
        return (self.dr, self.dc, len(self.offsets), rows, cols, int(clock0),
                int(n_steps))

    def persistent_args(self, a, clock0, n_steps, v_pre=None):
        """The arguments of ``model_stencil_persistent`` (``v_pre``: the
        emission plane, kind Izh only)."""
        return (*self.head(a), self.vbuf[0].data_ptr(),
                self.vbuf[1].data_ptr(),
                None if v_pre is None else v_pre.data_ptr(),
                self.weights.data_ptr(), self.in_deg.data_ptr(),
                *self.tail(clock0, n_steps), self.slots, self.plan.blocks,
                self.plan.cap)

    def launch(self, entry, args, out, what):
        """Call the C entry ``entry`` with ``args`` and then its launch
        counter and the current stream; raise on a CUDA error (``what``
        names the kernel), else make set ``out`` the state's.  Returns the
        kernel launches the entry counted."""
        launched = ctypes.c_int(0)
        dev = self.lft.device
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = getattr(self.lib, entry)(*args, ctypes.byref(launched),
                                          stream)
        if rc != 0:
            raise RuntimeError(f"{what} failed with CUDA error {rc} "
                               f"({torch.cuda.get_device_name(dev)})")
        self.cur = out
        return launched.value

    def outputs(self, out):
        """The carried planes, by name, and lft of set ``out``."""
        return {k: b[out] for k, b in self.bufs.items()}, self.lft_buf[out]


class ModelRun:
    """The calls of one run of the model kernel on one lattice: the
    checks, the layout check, the route and its plan, the output buffer
    sets and the launch arguments are made once, at construction
    (`RunSets`); each `steps` call then advances the state.

    ``planes``, ``lft``, ``weights``, ``in_deg`` and ``offsets`` are as for
    `model_steps`; the planes are only read.  A call's outputs are valid
    until the next call.  On CUDA tensors the persistent design runs where
    `persistent_plan` says so (``per_step`` forces the per-step one); on
    CPU tensors each call runs `model_steps_reference`."""

    def __init__(self, model, planes, lft, weights, in_deg, offsets,
                 per_step=False):
        fields, carry = _check(model, planes, lft, weights, in_deg, offsets,
                               0, 1)
        dev = lft.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"no kernel for device {dev}")
        self.model = model
        self.plan = lib = None
        if dev.type == "cuda":
            lib = kernel_library(model)
            check_layout(lib, kind(model), fields, carry,
                         model_read_fields(model), type(model).__name__)
            if not per_step:
                self.plan = persistent_plan(model, lft.shape, len(offsets),
                                            sm_count(dev))
        self.sets = RunSets(kind(model), fields, carry, planes, lft, weights,
                            in_deg, offsets, self.plan, lib)

    def steps(self, clock0, n_steps):
        """Advance ``n_steps`` steps from ``clock0``; returns ``(carried,
        lft, spikes)`` as `model_steps` does (on CUDA tensors, views into
        the buffer sets)."""
        global LAUNCHES, STEP_LAUNCHES
        check_clock(clock0, n_steps)
        s = self.sets
        if s.lib is None:
            planes, lft = s.state
            carried, lft, _ = model_steps_reference(
                self.model, planes, lft, s.weights, s.in_deg, s.offsets,
                clock0, n_steps)
            s.keep(carried, lft)
            return carried, lft, carried["is_spiking"]
        persistent = self.plan is not None
        a, out = next_sets(s.cur, call_launches(n_steps, persistent))
        if persistent:
            entry, args = ("model_stencil_persistent",
                           s.persistent_args(a, clock0, n_steps))
        else:
            entry, args = ("model_stencil_steps",
                           (*s.head(a), s.weights.data_ptr(),
                            s.in_deg.data_ptr(), *s.tail(clock0, n_steps)))
        STEP_LAUNCHES += s.launch(entry, args, out, "the model kernel")
        LAUNCHES += 1
        carried, lft = s.outputs(out)
        return carried, lft, carried["is_spiking"]


def model_steps(model, planes, lft, weights, in_deg, offsets, clock0,
                n_steps, per_step=False):
    """Advance ``n_steps`` electrical steps of ``model`` on a stencil
    lattice.

    ``planes`` maps every field of `model_kernel_fields` to its (rows,
    cols) plane (float32, bool or int32 as the field); ``lft`` is (rows,
    cols) int32, ``weights`` (len(offsets), rows, cols) float32, ``in_deg``
    (rows, cols) float32.  Returns ``(carried, lft, spikes)``: the planes of
    the fields the step writes, by name, the last firing times, and the
    last step's spikes (bool).  The inputs are not modified and the
    outputs are fresh tensors.  One call of a new `ModelRun`: on CUDA
    tensors the kernel of `uses_persistent`'s design (``per_step``: the
    per-step one, to compare the two), on CPU tensors the twin.
    """
    _check(model, planes, lft, weights, in_deg, offsets, clock0, n_steps)
    if lft.device.type == "cpu":
        return model_steps_reference(model, planes, lft, weights, in_deg,
                                     offsets, clock0, n_steps)
    return ModelRun(model, planes, lft, weights, in_deg, offsets,
                    per_step).steps(clock0, n_steps)


def model_steps_reference(model, planes, lft, weights, in_deg, offsets,
                          clock0, n_steps):
    """The plain PyTorch twin of the CUDA kernel, on any device.

    The gather in the kernel's association (``wsum`` and ``acc`` summed
    from 0 in offset order over slices of a zero-padded plane, then ``gap *
    (acc - v * wsum) / max(in_deg, 1)``), then the model's own ``step(...,
    skip_nt=True)`` on the (rows, cols) planes with `KERNEL_FNS`, then
    ``lft = clock0 + k`` where it spiked."""
    _, carry = model_kernel_fields(model)
    rows, cols = lft.shape
    pad = max([max(abs(dr), abs(dc)) for dr, dc in offsets], default=0)
    env = dict(planes)
    wsum = torch.zeros_like(env["v"])
    for o in range(len(offsets)):
        wsum = wsum + weights[o]
    cnt = torch.clamp(in_deg, min=1.0)
    spikes = None
    for k in range(int(n_steps)):
        v = env["v"]
        vp = F.pad(v, (pad, pad, pad, pad))
        acc = torch.zeros_like(v)
        for o, (dr, dc) in enumerate(offsets):
            acc = acc + weights[o] * vp[pad + dr:pad + dr + rows,
                                        pad + dc:pad + dc + cols]
        i_syn = env["gap_conductance"] * (acc - v * wsum) / cnt
        s2, spikes = model.step(env, i_syn, skip_nt=True, fns=KERNEL_FNS)
        env.update((key, s2[key]) for key in carry)
        lft = lft.masked_fill(spikes, int(clock0) + k)
    return {key: env[key] for key in carry}, lft, spikes

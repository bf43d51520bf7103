"""The elementwise-model stencil kernel: table, gate, wrapper and plain twin.

PyTorch/CUDA counterpart of the generic-model kernel of
``spiking_neural_networks_tpu/ops/pallas_stencil.py``
(`fused_model_multistep`), which traces any elementwise model's
``step(s, i, skip_nt=True)`` into a K-step stencil kernel.  Here a static
table names each model's kernel fields and the fields its step writes,
and ``csrc/model_stencil.cu`` holds one device functor per model that
repeats the model's own PyTorch step.

`model_steps` launches the CUDA kernel for CUDA tensors and runs the plain
twin `model_steps_reference` for CPU tensors.  The twin runs the port
model's own ``step`` on (rows, cols) planes with `KERNEL_FNS`, the
float-op exp, tanh and cosh the kernel computes, so the kernel route on
the card equals the same route on the CPU bit for bit.  A build or launch
failure raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..core.plasticity import kernel_cosh, kernel_exp, kernel_tanh
from ..models.base import Fns
from ..models.dopa import DopaIzhikevich
from ..models import integrate_and_fire as iaf
from ..models.morris_lecar import MorrisLecar

MAX_OFFSETS = 64          # MS_MAX_OFFSETS in the CUDA source
MAX_FIELDS = 32           # MS_MAX_FIELDS
STEPS_PER_LAUNCH = 16     # K of the lattice runner's kernel calls
KERNEL_FNS = Fns(kernel_exp, kernel_tanh, kernel_cosh)

# Calls of `model_steps` that launched the CUDA kernel (each call runs its
# n_steps launches on the stream).
LAUNCHES = 0

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
_layouts_checked = set()


def model_kernel_fields(model):
    """``(fields, carry)``: ``fields`` the ((name, dtype), ...) planes the
    kernel takes (float fields, bool fields, int fields, then
    ``is_spiking``), ``carry`` the names the step writes, in field order;
    None for a model outside the table."""
    entry = _TABLE.get(type(model))
    if entry is None:
        return None
    fields = tuple((k, torch.float32) for k in model.FIELDS) \
        + tuple((k, torch.bool) for k in model.BOOL_FIELDS) \
        + tuple((k, torch.int32) for k in model.INT_FIELDS) \
        + (("is_spiking", torch.bool),)
    return fields, entry[1]


def model_read_fields(model):
    """The names of the kernel fields the model's step reads, in field
    order (the others it writes only, or ignores)."""
    unread = _TABLE[type(model)][2]
    return tuple(k for k, _ in model_kernel_fields(model)[0]
                 if k not in unread)


def kind(model):
    """The model's kind in the CUDA source."""
    k = _TABLE[type(model)][0]
    return k + 1 if getattr(model, "chemical_normalization", False) else k


def supports_model(model, graph, electrical, chemical, do_plasticity):
    """Whether the kernel computes this lattice configuration's step: a
    model of the table with an elementwise step, a `StencilGraph` of at
    most `MAX_OFFSETS` offsets, electrical synapses only, no plasticity."""
    from .graph import StencilGraph
    return (type(model) in _TABLE
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
    if int(n_steps) < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if not -2**31 <= int(clock0) <= 2**31 - int(n_steps):
        raise ValueError(f"clock {clock0} + {n_steps} steps overflows int32")
    return fk


def _check_layout(lib, model, fields, carry):
    """Raise unless the CUDA source's layout of this kind (field count,
    types, carried and read fields) is the table's."""
    k = kind(model)
    if k in _layouts_checked:
        return
    codes = (ctypes.c_int * MAX_FIELDS)()
    n = lib.model_stencil_layout(k, codes)
    reads = model_read_fields(model)
    want = [_CODES[dt] + (_CARRIED if name in carry else 0)
            + (_READ if name in reads else 0) for name, dt in fields]
    if n != len(fields) or list(codes[:n]) != want:
        raise RuntimeError(
            f"the CUDA layout of {type(model).__name__} (kind {k}: "
            f"{list(codes[:max(n, 0)])}) differs from the table's {want}")
    _layouts_checked.add(k)


def model_steps(model, planes, lft, weights, in_deg, offsets, clock0,
                n_steps):
    """Advance ``n_steps`` electrical steps of ``model`` on a stencil
    lattice.

    ``planes`` maps every field of `model_kernel_fields` to its (rows,
    cols) plane (float32, bool or int32 as the field); ``lft`` is (rows,
    cols) int32, ``weights`` (len(offsets), rows, cols) float32, ``in_deg``
    (rows, cols) float32.  Returns ``(carried, lft, spikes)``: the planes of
    the fields the step writes, by name, the last firing times, and the
    last step's spikes (bool).  The inputs are not modified.
    """
    global LAUNCHES
    fields, carry = _check(model, planes, lft, weights, in_deg, offsets,
                           clock0, n_steps)
    if lft.device.type == "cpu":
        return model_steps_reference(model, planes, lft, weights, in_deg,
                                     offsets, clock0, n_steps)
    if lft.device.type != "cuda":
        raise ValueError(f"no kernel for device {lft.device}")
    from .. import _build
    lib = _build.load()
    _check_layout(lib, model, fields, carry)
    dev = lft.device
    with torch.cuda.device(dev):
        rc, out = _launch(lib, model, fields, carry, planes, lft, weights,
                          in_deg, offsets, clock0, n_steps,
                          torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"model_stencil_steps failed with CUDA error {rc} "
                           f"({torch.cuda.get_device_name(dev)})")
    LAUNCHES += 1
    return out


def _launch(lib, model, fields, carry, planes, lft, weights, in_deg,
            offsets, clock0, n_steps, stream):
    """One call of the C entry on ``stream``, its outputs allocated beside
    ``lft``: two buffers a carried plane, one of which (the last step's)
    the caller keeps.  Returns (CUDA error code, (carried, lft,
    spikes))."""
    rows, cols = lft.shape
    n_steps, n_off = int(n_steps), len(offsets)
    dev = lft.device
    new = lambda dtype: [torch.empty((rows, cols), dtype=dtype, device=dev)
                         for _ in (0, 1)]
    bufs = {k: new(planes[k].dtype) for k in carry}
    lft_buf = new(torch.int32)
    ptrs = ctypes.c_void_p * len(fields)
    field_ptrs = ptrs(*[planes[k].data_ptr() for k, _ in fields])
    buf_ptrs = [ptrs(*[bufs[k][b].data_ptr() if k in bufs else None
                       for k, _ in fields]) for b in (0, 1)]
    dr = (ctypes.c_int * max(n_off, 1))(*[o[0] for o in offsets])
    dc = (ctypes.c_int * max(n_off, 1))(*[o[1] for o in offsets])
    rc = lib.model_stencil_steps(
        kind(model), field_ptrs, len(fields), buf_ptrs[0], buf_ptrs[1],
        lft.data_ptr(), lft_buf[0].data_ptr(), lft_buf[1].data_ptr(),
        weights.data_ptr(), in_deg.data_ptr(), dr, dc, n_off, rows, cols,
        int(clock0), n_steps, stream)
    last = (n_steps - 1) % 2
    carried = {k: b[last] for k, b in bufs.items()}
    return rc, (carried, lft_buf[last], carried["is_spiking"])


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

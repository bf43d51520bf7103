"""The electrical Izhikevich stencil kernel: wrapper, plain twin and gate.

PyTorch/CUDA counterpart of ``spiking_neural_networks_tpu/ops/
pallas_stencil.py``.  The three TPU kernels that carry the electrical
Izhikevich lattice there (the per-step kernel, the whole-lattice multi-step
kernel and the row-tiled multi-step kernel) compute one function:
(v, w, lft, spikes[, v_pre]) after K steps from ``clock0``.  Here that is one
hand-written CUDA kernel, ``csrc/izhikevich_stencil.cu``, with per-neuron
parameter planes.

`izhikevich_stencil_steps` launches it for CUDA tensors and runs the plain
twin `izhikevich_stencil_steps_reference` for CPU tensors (the counterpart
of the TPU kernels' interpret mode).  A build or launch failure raises;
nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

PARAM_ORDER = ("a", "b", "c", "d", "v_th", "gap_conductance", "tau_m",
               "c_m", "dt")
MAX_OFFSETS = 64          # IZH_MAX_OFFSETS in the CUDA source
STEPS_PER_LAUNCH = 16     # K of the lattice runner's kernel calls

# Calls of `izhikevich_stencil_steps` that launched the CUDA kernel (each
# call runs its n_steps launches on the stream).
LAUNCHES = 0


def supports(model, graph, electrical, chemical, do_plasticity):
    """Whether the kernel computes this lattice configuration's step."""
    from ..models.integrate_and_fire import Izhikevich
    from .graph import StencilGraph
    return (type(model) is Izhikevich and isinstance(graph, StencilGraph)
            and len(graph.offsets) <= MAX_OFFSETS
            and electrical and not chemical and not do_plasticity)


def _check(v, w, lft, weights, in_deg, params, offsets, clock0, n_steps):
    if v.dim() != 2:
        raise ValueError(f"v must be a (rows, cols) plane, got {tuple(v.shape)}")
    shape, dev = v.shape, v.device
    planes = {"v": v, "w": w, "in_deg": in_deg}
    missing = [k for k in PARAM_ORDER if k not in params]
    if missing:
        raise KeyError(f"missing parameter planes: {missing}")
    planes.update((k, params[k]) for k in PARAM_ORDER)
    for name, t in planes.items():
        if t.dtype != torch.float32 or t.shape != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous float32 {tuple(shape)} tensor "
                f"on {dev}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    if lft.dtype != torch.int32 or lft.shape != shape or lft.device != dev \
            or not lft.is_contiguous():
        raise ValueError(f"lft must be a contiguous int32 {tuple(shape)} "
                         f"tensor on {dev}")
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


def izhikevich_stencil_steps(v, w, lft, weights, in_deg, params, offsets,
                             clock0, n_steps, emit=False):
    """Advance ``n_steps`` electrical Izhikevich steps.

    ``v``, ``w``, ``in_deg`` and the planes of ``params`` (keys
    `PARAM_ORDER`) are (rows, cols) float32; ``lft`` is (rows, cols) int32;
    ``weights`` is (len(offsets), rows, cols) float32.  Returns
    ``(v, w, lft, spikes, v_pre)``: spikes are the last step's (bool), and
    ``v_pre`` is the (n_steps, rows, cols) pre-reset voltage of each step
    when ``emit`` is true, else None.  The inputs are not modified.
    """
    global LAUNCHES
    _check(v, w, lft, weights, in_deg, params, offsets, clock0, n_steps)
    if v.device.type == "cpu":
        return izhikevich_stencil_steps_reference(
            v, w, lft, weights, in_deg, params, offsets, clock0, n_steps,
            emit)
    if v.device.type != "cuda":
        raise ValueError(f"no kernel for device {v.device}")
    from .. import _build
    lib = _build.load()
    rows, cols = v.shape
    n_steps, n_off = int(n_steps), len(offsets)
    v_buf = torch.empty((2, rows, cols), dtype=torch.float32, device=v.device)
    w_buf = torch.empty_like(v_buf)
    lft_buf = torch.empty((2, rows, cols), dtype=torch.int32, device=v.device)
    spikes = torch.empty((rows, cols), dtype=torch.bool, device=v.device)
    v_pre = torch.empty((n_steps, rows, cols), dtype=torch.float32,
                        device=v.device) if emit else None
    param_ptrs = (ctypes.c_void_p * len(PARAM_ORDER))(
        *[params[k].data_ptr() for k in PARAM_ORDER])
    dr = (ctypes.c_int * max(n_off, 1))(*[o[0] for o in offsets])
    dc = (ctypes.c_int * max(n_off, 1))(*[o[1] for o in offsets])
    stream = torch.cuda.current_stream(v.device).cuda_stream
    with torch.cuda.device(v.device):
        rc = lib.izh_stencil_steps(
            v.data_ptr(), w.data_ptr(), lft.data_ptr(),
            weights.data_ptr(), in_deg.data_ptr(), param_ptrs,
            v_buf[0].data_ptr(), w_buf[0].data_ptr(), lft_buf[0].data_ptr(),
            v_buf[1].data_ptr(), w_buf[1].data_ptr(), lft_buf[1].data_ptr(),
            spikes.data_ptr(), v_pre.data_ptr() if emit else None,
            dr, dc, n_off, rows, cols, int(clock0), n_steps, stream)
    if rc != 0:
        raise RuntimeError(f"izh_stencil_steps failed with CUDA error {rc} "
                           f"({torch.cuda.get_device_name(v.device)})")
    LAUNCHES += 1
    last = (n_steps - 1) % 2
    return v_buf[last], w_buf[last], lft_buf[last], spikes, v_pre


def izhikevich_stencil_steps_reference(v, w, lft, weights, in_deg, params,
                                       offsets, clock0, n_steps, emit=False):
    """The plain PyTorch twin of the CUDA kernel, on any device.

    Same association and offset order as the kernel (and as the TPU
    kernels): ``wsum`` and ``acc`` summed from 0 in offset order, then
    ``gap * (acc - v * wsum) / max(in_deg, 1)``.  Shifted reads are slices
    of a zero-padded plane, so an off-grid neighbour adds ``w * 0``, which
    leaves ``acc`` as the kernel's bounds check does.
    """
    rows, cols = v.shape
    pad = max([max(abs(dr), abs(dc)) for dr, dc in offsets], default=0)
    a, b, c, d, v_th, gap, tau_m, c_m, dt = (params[k] for k in PARAM_ORDER)
    wsum = torch.zeros_like(v)
    for o in range(len(offsets)):
        wsum = wsum + weights[o]
    cnt = torch.clamp(in_deg, min=1.0)
    dt_cm = dt / c_m
    dt_tau = dt / tau_m
    v_pres = []
    spikes = None
    for k in range(int(n_steps)):
        vp = F.pad(v, (pad, pad, pad, pad))
        acc = torch.zeros_like(v)
        for o, (dr, dc) in enumerate(offsets):
            acc = acc + weights[o] * vp[pad + dr:pad + dr + rows,
                                        pad + dc:pad + dc + cols]
        i_syn = gap * (acc - v * wsum) / cnt
        dv = (0.04 * v * v + 5.0 * v + 140.0 - w + i_syn) * dt_cm
        dw = (a * (b * v - w)) * dt_tau
        v_pre = v + dv
        w_pre = w + dw
        spikes = v_pre >= v_th
        v = torch.where(spikes, c, v_pre)
        w = torch.where(spikes, w_pre + d, w_pre)
        lft = lft.masked_fill(spikes, int(clock0) + k)
        if emit:
            v_pres.append(v_pre)
    return v, w, lft, spikes, torch.stack(v_pres) if emit else None

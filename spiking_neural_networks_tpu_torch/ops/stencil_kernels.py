"""The electrical Izhikevich stencil kernel: wrapper, plan, plain twin and
gate.

PyTorch/CUDA counterpart of ``spiking_neural_networks_tpu/ops/
pallas_stencil.py``.  The three TPU kernels that carry the electrical
Izhikevich lattice there (the per-step kernel, the whole-lattice multi-step
kernel and the row-tiled multi-step kernel) compute one function:
(v, w, lft, spikes[, v_pre]) after K steps from ``clock0``.  Here that
function has three hand-written CUDA designs, routed by `route`:

* persistent (``csrc/model_stencil.cu``, kind `IZH_KIND`): one cooperative
  launch per 16 steps, a block's weights and parameter planes in shared
  memory, the state in registers, where `persistent_plan` holds the
  weights (512^2 at radius 2);
* tiled (``csrc/izhikevich_stencil.cu``): temporal blocking, K_b steps a
  launch, the parameters as 9 scalars, where every parameter plane is
  uniform and the stencil reaches at most `TILE_MAX_PAD` cells (1024^2
  and up), on the plan of `tiled_plan`, by the stencil's reach: streamed
  rows (`izh_tiled_kernel_rows`, `stream_plan`: strips of columns marched
  down r rows an iteration through shared-memory rings, each weight
  loaded once a launch and the loads under the arithmetic) at a reach of 2
  to 4, 2-D tiles (`izh_tiled_kernel`, `tile_plan`: a tile plus a K_b * pad
  halo loaded, then computed) at a reach of 1;
* per step (``csrc/izhikevich_stencil.cu``, `izh_stencil_step_kernel`):
  one launch a step with per-neuron planes, for the rest and for the
  comparison (``design="per_step"``).

`StencilRun` makes the checks, the uniform check, the route and its plan,
the buffer sets and the launch arguments once for a run of calls
(`core.lattice.Lattice._run_kernel`), its state between calls in
`model_kernels.RunSets`, the run skeleton it shares with the model
kernel; `izhikevich_stencil_steps` is one call of a fresh `StencilRun`.
Every design is bit-equal to the plain twin
`izhikevich_stencil_steps_reference`, which CPU tensors run (the
counterpart of the TPU kernels' interpret mode).  A build or launch
failure raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import model_kernels
from .model_kernels import SMEM_BUDGET
from ..utils import profiling

PARAM_ORDER = ("a", "b", "c", "d", "v_th", "gap_conductance", "tau_m",
               "c_m", "dt")
MAX_OFFSETS = 64          # IZH_MAX_OFFSETS in the CUDA source
STEPS_PER_LAUNCH = 16     # K of the lattice runner's kernel calls
TILE_THREADS = 1024       # IZH_TILE_THREADS: a tiled block's threads, at most
TILE_MAX_CPT = 4          # IZH_TILE_MAX_CPT: loaded cells a tiled thread
TILE_MAX_PAD = 4          # the widest stencil the tiled design takes (as the
                          # JAX package's multistep_tiled_config)
# The tiled design's 2-D tile at a stencil reach of 1 (`tile_plan`):
# (interior rows, interior columns, steps a launch).  There it runs faster
# than every streamed plan tried (PERF.md section 6 row 3); a reach of 2 to
# 4 streams.
TILE = (48, 48, 4)
# The streamed plan's steps a launch (the kernel's instantiations, the most
# first), the threads of a block at most (IZH_STREAM_THREADS), and its cost
# model's rates, which only rank a kb's strip widths: an SM's cycles a
# level's phase takes, fixed and a warp
# (a barrier, then each warp's cell: loads, 12 dependent adds, a division;
# fitted to the H100 times of PERF.md section 6 row 3) and a loaded byte
# (3.35 TB/s shared by 132 SMs at 1.755 GHz).
STREAM_KBS = (8, 4, 2)
STREAM_THREADS = 384
STREAM_PHASE_CYCLES = 540.0
STREAM_WARP_CYCLES = 20.0
STREAM_BYTE_CYCLES = 0.07
# The persistent design's kind in csrc/model_stencil.cu (MS_IZH), its
# fields in order (v, w, the parameter planes, is_spiking), those its step
# writes and those it reads.
IZH_KIND = 10
IZH_FIELDS = tuple((k, torch.float32) for k in ("v", "w") + PARAM_ORDER) \
    + (("is_spiking", torch.bool),)
IZH_CARRY = ("v", "w", "is_spiking")
IZH_READS = ("v", "w") + PARAM_ORDER
# The SMs a run on CPU tensors plans for (an H100's): the route it reports.
CPU_SM_COUNT = 132

# Calls of the kernel (`izhikevich_stencil_steps`, `StencilRun.steps`) that
# launched CUDA kernels.
LAUNCHES = 0
# The CUDA kernel launches those calls made, as the C entries count them at
# each launch (`call_launches` per call).
STEP_LAUNCHES = 0
# Those calls by design, and the tiled ones that took the streamed plan.
DESIGN_CALLS = {"persistent": 0, "tiled": 0, "per_step": 0}
STREAMED_CALLS = 0
_checked = set()


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
    model_kernels.check_clock(clock0, n_steps)


class TilePlan(NamedTuple):
    """The tiled design's 2-D tile: interior ``th`` x ``tw`` cells, ``kb``
    steps a launch, a halo of ``halo`` = kb * pad cells on each side, so a
    loaded tile of ``lh`` x ``lw`` cells, held by ``threads`` threads of
    ``cpt`` cells each, in ``smem`` bytes (the weights and two v
    buffers)."""
    th: int
    tw: int
    kb: int
    halo: int
    lh: int
    lw: int
    cpt: int
    threads: int
    smem: int


def stencil_pad(offsets):
    """The stencil's reach: its largest |dr| or |dc| (0 without
    offsets)."""
    return max([max(abs(dr), abs(dc)) for dr, dc in offsets], default=0)


def tile_config(th, tw, kb, offsets, budget=SMEM_BUDGET):
    """The `TilePlan` of a (th, tw) interior at kb steps a launch for
    ``offsets``: the fewest cells a thread that `TILE_THREADS` threads
    hold, or None where that exceeds `TILE_MAX_CPT` or the shared memory
    exceeds ``budget``."""
    halo = int(kb) * stencil_pad(offsets)
    lh, lw = int(th) + 2 * halo, int(tw) + 2 * halo
    cells = lh * lw
    smem = 4 * cells * (len(offsets) + 2)
    cpt = -(-cells // TILE_THREADS)
    if cpt > TILE_MAX_CPT or smem > budget:
        return None
    threads = 32 * -(-(-(-cells // cpt)) // 32)
    return TilePlan(int(th), int(tw), int(kb), halo, lh, lw, cpt, threads,
                    smem)


def tile_plan(offsets):
    """The tiled design's 2-D tile (`TILE`) for ``offsets`` where the
    stencil reaches at most 1 cell, else None."""
    return tile_config(*TILE, offsets) if stencil_pad(offsets) <= 1 \
        else None


class StreamPlan(NamedTuple):
    """The tiled design's streamed plan.  Block (x, y) of ``strips`` x
    ``segments`` owns the interior columns [x tw, x tw + tw) and rows
    [y seg, y seg + seg), clipped to the grid.  It loads the columns of its
    strip with ``halo`` = kb * pad more on each side (``lw`` = tw + 2 halo)
    and marches down its segment's rows from ``halo`` above it to ``halo``
    below it, ``r`` rows (>= pad) an iteration: the newest rows' v, one
    iteration later their weights, w and in_deg.  Time level l (1..kb, a
    step each) computes the rows l * r behind the newest, on columns and
    rows within (kb - l) * pad of the interior, so the interior is exact
    after kb levels; it reads level l - 1's rows, this iteration's too,
    behind a barrier between levels.  Shared memory (``smem`` bytes) holds
    the rings of `stream_rings` (the weights ``stride`` floats a cell);
    ``threads`` = r * lw (to a warp), thread (i, c) the cell of each
    level's row i, column c."""
    kb: int
    r: int
    pad: int
    tw: int
    seg: int
    halo: int
    lw: int
    stride: int
    strips: int
    segments: int
    threads: int
    smem: int


def weight_stride(n_off):
    """Floats a cell's weights take in the streamed ring: ``n_off`` to a
    multiple of 4 whose quarter is odd, so that a warp's 16-byte reads of
    neighbouring cells hit every bank once."""
    s = -(-int(n_off) // 4) * 4
    return s + 4 if s and s // 4 % 2 == 0 else s


def stream_rings(kb, r, pad):
    """Rows of the streamed design's rings: the weights' ((kb + 1) r =
    kb * pad + r at r = pad: the rows levels 1..kb compute, and the r rows
    in flight), the loaded v's (3 r + pad: level 1's windows, the rows
    landed and the rows in flight) and each of levels 1..kb-1's v (2 r +
    pad: the next level's windows and this level's newest rows).  The v
    rings hold each row twice (at its slot and depth rows on), so that a
    window of 2 pad + 1 rows never wraps."""
    return (kb + 1) * r, 3 * r + pad, 2 * r + pad


def stream_smem(kb, r, pad, stride, lw):
    """Shared-memory bytes of a streamed block ``lw`` cells wide."""
    wring, v0, lv = stream_rings(kb, r, pad)
    return 4 * lw * (wring * stride + 2 * v0 + (kb - 1) * 2 * lv)


def _stream_cost(kb, r, pad, n_off, tw, seg, lw, blocks, n_sm):
    """The cost model's SM cycles a step of a plan's slowest block: the
    larger of its phases (each level's rows, r a phase, and each
    iteration's own) and its loads, over kb steps, times the waves."""
    warps = -(-r * lw // 32)
    phases = sum(-(-(seg + 2 * (kb - l) * pad) // r)
                 for l in range(1, kb + 1))
    phases += -(-(seg + 2 * kb * pad) // r) + kb + 1
    loaded = (seg + 2 * kb * pad) * lw * 4 * (n_off + 3) + seg * tw * 17
    compute = phases * (STREAM_PHASE_CYCLES + STREAM_WARP_CYCLES * warps)
    return (-(-blocks // n_sm) * max(compute, STREAM_BYTE_CYCLES * loaded)
            / kb)


def stream_plan(shape, offsets, n_sm, budget=SMEM_BUDGET):
    """The streamed plan (`StreamPlan`) of a ``shape`` lattice on a card of
    ``n_sm`` SMs, or None where the stencil reaches farther than
    `TILE_MAX_PAD` or no strip fits ``budget``.  The most steps a launch
    of `STREAM_KBS` whose widest strip (by the budget and
    `STREAM_THREADS`) is at least 4 (kb - 1) pad columns wide, so that the
    halo's work stays within a quarter (else the fewest that fits), r =
    pad rows an iteration; then, from that widest strip to strips half
    as wide, the width that divides the columns evenly with as many
    segments as keep one block an SM that the cost model rates fastest."""
    pad = stencil_pad(offsets)
    if pad > TILE_MAX_PAD:
        return None
    rows, cols = (int(x) for x in shape)
    n_off = len(offsets)
    r = max(pad, 1)
    stride = weight_stride(n_off)
    fits = []
    for kb in STREAM_KBS:
        tw_max = min(budget // stream_smem(kb, r, pad, stride, 1),
                     STREAM_THREADS // r) - 2 * kb * pad
        if tw_max >= 1:
            fits.append((kb, tw_max))
    if not fits:
        return None
    kb, tw_max = next((f for f in fits if f[1] >= 4 * (f[0] - 1) * pad),
                      fits[-1])
    halo = kb * pad
    best = None
    first = -(-cols // tw_max)
    for strips in range(first, 2 * first + 1):
        tw = -(-cols // strips)
        if -(-cols // tw) != strips:
            continue
        lw = tw + 2 * halo
        segments = max(1, min(n_sm // strips, -(-rows // r)))
        seg = -(-rows // segments)
        segments = -(-rows // seg)
        cost = _stream_cost(kb, r, pad, n_off, tw, seg, lw,
                            strips * segments, n_sm)
        if best is None or cost < best[0]:
            best = (cost, StreamPlan(
                kb, r, pad, tw, seg, halo, lw, stride, strips, segments,
                32 * -(-r * lw // 32), stream_smem(kb, r, pad, stride, lw)))
    return best[1]


def tiled_plan(shape, offsets, n_sm):
    """The tiled design's plan, by the stencil's reach: the 2-D tile
    (`tile_plan`) at a reach of at most 1, the streamed plan
    (`stream_plan`) at 2 to `TILE_MAX_PAD`, else None.  At a reach of 1 a
    level's cells are too few for the streamed plan's barriers (PERF.md
    section 6 row 3)."""
    return tile_plan(offsets) or stream_plan(shape, offsets, n_sm)


def persistent_plan(shape, n_off, n_blocks, budget=SMEM_BUDGET):
    """The persistent design's plan (`model_kernels.MsPlan`) on a
    ``shape`` lattice of ``n_off`` offsets on a card of ``n_blocks`` SMs,
    or None where a block's weights do not fit: the model kernel's plan
    for the plain Izhikevich, whose IN fields are the 9 parameter
    planes."""
    return model_kernels.plan_cells(shape, n_off, n_blocks, PARAM_ORDER,
                                    model_kernels.MAX_CPT, budget)


def uniform_scalars(params):
    """The 9 parameters as floats where every plane holds one value, bit
    for bit (float equality that also tells -0.0 from 0.0, so that the
    scalars give the planes' bits), else None.  One read from the
    device."""
    rows = []
    for k in PARAM_ORDER:
        flat = params[k].reshape(-1)
        bits = flat.view(torch.int32)
        rows.append(torch.stack([(bits == bits[0]).all().to(flat.dtype),
                                 flat[0]]))
    with profiling.span("wait.uniform_scalars"):
        got = torch.stack(rows).cpu().tolist()
    if not all(flag == 1.0 for flag, _ in got):
        return None
    return tuple(x for _, x in got)


def route(shape, offsets, n_blocks, scalars, design=None, plan=None):
    """``(design, plan)`` of a run: "persistent" and its `MsPlan` where
    `persistent_plan` holds the weights; else "tiled" and its plan
    (`tiled_plan`: a `TilePlan` or a `StreamPlan`) where the
    parameters are uniform (``scalars``: a callable giving
    `uniform_scalars`' result, called only here) and the stencil reaches
    at most `TILE_MAX_PAD`; else "per_step" and None.  ``design`` forces
    one (ValueError where it does not apply); ``plan`` forces the tiled
    design with that plan (ValueError with another ``design``)."""
    if plan is not None:
        if design not in (None, "tiled"):
            raise ValueError(f"a tiled plan with design {design!r}")
        if stencil_pad(offsets) > TILE_MAX_PAD or scalars() is None:
            raise ValueError("a tiled plan needs uniform parameter planes "
                             f"and a stencil of reach <= {TILE_MAX_PAD}")
        return "tiled", plan
    if design not in (None, "persistent", "tiled", "per_step"):
        raise ValueError(f"no design {design!r}")
    if design == "per_step":
        return "per_step", None
    if design in (None, "persistent"):
        plan = persistent_plan(shape, len(offsets), n_blocks)
        if plan is not None:
            return "persistent", plan
        if design == "persistent":
            raise ValueError(f"the persistent design cannot hold a "
                             f"{tuple(shape)} lattice's weights")
    plan = tiled_plan(shape, offsets, n_blocks)
    if plan is not None and scalars() is not None:
        return "tiled", plan
    if design == "tiled":
        raise ValueError("the tiled design needs uniform parameter planes "
                         f"and a stencil of reach <= {TILE_MAX_PAD}")
    return "per_step", None


def call_launches(n_steps, design, plan=None):
    """The CUDA kernel launches of one call of ``n_steps`` steps: one per
    `STEPS_PER_LAUNCH` steps in the persistent design, one per ``plan.kb``
    steps in the tiled one, one a step in the per-step one."""
    n = int(n_steps)
    if design == "persistent":
        return model_kernels.call_launches(n, True)
    if design == "tiled":
        return -(-n // plan.kb)
    return n


def _check_library(lib):
    """Raise unless the CUDA sources' limits and the persistent kind's
    layout are this module's."""
    if "izh" in _checked:
        return
    got = (ctypes.c_int * 4)()
    lib.izh_stencil_limits(got)
    want = [MAX_OFFSETS, TILE_THREADS, TILE_MAX_CPT, STREAM_THREADS]
    if list(got) != want:
        raise RuntimeError(f"the stencil kernel's limits {list(got)} differ "
                           f"from the wrapper's {want}")
    model_kernels.check_layout(lib, IZH_KIND, IZH_FIELDS, IZH_CARRY,
                               IZH_READS, "Izhikevich")
    _checked.add("izh")


class StencilRun:
    """The calls of one run of the stencil kernel on one lattice: the
    checks, the uniform check, the route and its plan, the output buffer
    sets and the launch arguments are made once, at construction
    (`model_kernels.RunSets` holds the state between calls); each `steps`
    call then advances the state.

    The arguments are as for `izhikevich_stencil_steps`; the planes are
    only read, and a call's outputs are valid until the next call.
    ``design`` forces a design and ``plan`` the tiled one's plan
    (`route`).  On
    CUDA tensors the route's kernel runs.  On CPU tensors each call runs
    `izhikevich_stencil_steps_reference`; the route, which they do not
    take, is the one an H100 (`CPU_SM_COUNT`) would, so that the route
    rule can be checked through the runner without a card."""

    def __init__(self, v, w, lft, weights, in_deg, params, offsets,
                 design=None, plan=None):
        with profiling.span("stencil.setup"):
            self._setup(v, w, lft, weights, in_deg, params, offsets, design,
                        plan)

    def _setup(self, v, w, lft, weights, in_deg, params, offsets, design,
               plan):
        _check(v, w, lft, weights, in_deg, params, offsets, 0, 1)
        dev = v.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"no kernel for device {dev}")
        cuda = dev.type == "cuda"
        self.params = {k: params[k] for k in PARAM_ORDER}
        self.scalars = None

        def scalars():
            self.scalars = uniform_scalars(self.params)
            return self.scalars

        n_blocks = model_kernels.sm_count(dev) if cuda else CPU_SM_COUNT
        self.design, self.plan = route(v.shape, offsets, n_blocks, scalars,
                                       design, plan)
        self.streamed = isinstance(self.plan, StreamPlan)
        if cuda:
            from .. import _build
            _check_library(_build.load())
        self.sets = model_kernels.RunSets(
            IZH_KIND, IZH_FIELDS, IZH_CARRY, dict(self.params, v=v, w=w),
            lft, weights, in_deg, offsets,
            self.plan if self.design == "persistent" else None)
        # the parameters of the per-step entry (planes) or the tiled one
        # (scalars)
        if cuda and self.design == "per_step":
            self.param_arg = (ctypes.c_void_p * len(PARAM_ORDER))(
                *[self.params[k].data_ptr() for k in PARAM_ORDER])
        elif cuda and self.design == "tiled":
            self.param_arg = (ctypes.c_float * len(PARAM_ORDER))(
                *self.scalars)

    def launches(self, n_steps):
        """The kernel launches of a call of ``n_steps`` steps."""
        return call_launches(n_steps, self.design, self.plan)

    def steps(self, clock0, n_steps, emit=False):
        """Advance ``n_steps`` steps from ``clock0``; returns ``(v, w, lft,
        spikes, v_pre)`` as `izhikevich_stencil_steps` does (on CUDA
        tensors, views into the run's buffer sets; ``v_pre`` a fresh
        (n_steps, rows, cols) plane)."""
        with profiling.span("stencil.call"):
            return self._steps(clock0, n_steps, emit)

    def _steps(self, clock0, n_steps, emit):
        global LAUNCHES, STEP_LAUNCHES, STREAMED_CALLS
        model_kernels.check_clock(clock0, n_steps)
        n_steps = int(n_steps)
        s = self.sets
        if s.lib is None:
            planes, lft = s.state
            out = izhikevich_stencil_steps_reference(
                planes["v"], planes["w"], lft, s.weights, s.in_deg,
                self.params, s.offsets, clock0, n_steps, emit)
            s.keep({"v": out[0], "w": out[1]}, out[2])
            return out
        a, out = model_kernels.next_sets(s.cur, self.launches(n_steps))
        rows, cols = s.lft.shape
        v_pre = torch.empty((n_steps, rows, cols), dtype=torch.float32,
                            device=s.lft.device) if emit else None
        if self.design == "persistent":
            entry = "model_stencil_persistent"
            args = s.persistent_args(a, clock0, n_steps, v_pre)
        else:
            # (v, w, lft) of the inputs, then of set a and set 1 - a
            state = lambda b: (s.in_ptrs[b][0], s.in_ptrs[b][1],
                               s.lft_ptrs[b])
            args = (*state(s.cur), s.weights.data_ptr(), s.in_deg.data_ptr(),
                    self.param_arg, *state(a), *state(1 - a),
                    s.bufs["is_spiking"][out].data_ptr(),
                    None if v_pre is None else v_pre.data_ptr(),
                    *s.tail(clock0, n_steps))
            entry = "izh_stencil_steps"
            if self.design == "tiled" and self.streamed:
                p = self.plan
                entry = "izh_stencil_tiled"
                args += (p.tw, p.seg, p.kb, p.r, p.threads)
            elif self.design == "tiled":
                p = self.plan
                entry = "izh_stencil_tiled2d"
                args += (p.th, p.tw, p.kb, p.threads, p.cpt)
        STEP_LAUNCHES += s.launch(entry, args, out,
                                  f"the stencil kernel ({self.design})")
        LAUNCHES += 1
        DESIGN_CALLS[self.design] += 1
        STREAMED_CALLS += self.streamed
        carried, lft = s.outputs(out)
        return carried["v"], carried["w"], lft, carried["is_spiking"], v_pre


def izhikevich_stencil_steps(v, w, lft, weights, in_deg, params, offsets,
                             clock0, n_steps, emit=False):
    """Advance ``n_steps`` electrical Izhikevich steps.

    ``v``, ``w``, ``in_deg`` and the planes of ``params`` (keys
    `PARAM_ORDER`) are (rows, cols) float32; ``lft`` is (rows, cols) int32;
    ``weights`` is (len(offsets), rows, cols) float32.  Returns
    ``(v, w, lft, spikes, v_pre)``: spikes are the last step's (bool), and
    ``v_pre`` is the (n_steps, rows, cols) pre-reset voltage of each step
    when ``emit`` is true, else None.  The inputs are not modified and the
    outputs are fresh tensors.  One call of a new `StencilRun`: the
    routed design on CUDA tensors, the twin on CPU tensors.
    """
    return StencilRun(v, w, lft, weights, in_deg, params, offsets).steps(
        clock0, n_steps, emit)


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

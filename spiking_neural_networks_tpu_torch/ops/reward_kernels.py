"""The single-lattice plasticity kernel: wrapper, plain twin and gates.

PyTorch/CUDA counterpart of the single-lattice form of
``spiking_neural_networks_tpu/ops/pallas_reward.py`` (`_fused_chunk`, body
`_make_kernel`): K steps of one stencil lattice of Izhikevich, adaptive
leaky (ALIF) or leaky (LIF) integrate-and-fire neurons, where each step
runs, in this order,

1. phase A, the electrical input from the current weights:
   ``gap * (acc - v * wsum) / max(in_deg, 1)``;
2. the dopamine update ``dop = dop * exp_dd + tau_d * reward`` (with a
   reward only);
3. phase B, the model step, and ``lft = clock0 + k`` on a spike;
4. kind ``plastic``: STDP on every masked slot from the post-step firing
   times and spikes, ``w += delta * (spk_pre + spk_post)``;
   kind ``mod``: the R-STDP double visit of weights and traces.

Kind ``plain`` stops after phase B.  On a GPU this is the hand-written
CUDA kernel ``csrc/lattice_plasticity.cu``: K + 1 launches per K-step call,
launch k running step k-1's edge pass and then step k's phases (K for kind
``plain``); ``_per_step=True`` takes the earlier design, a cell and an
edge launch per step, which the runner takes where it measured faster
(`per_step_route`: STDP on ALIF from 512 x 512).
`lattice_plasticity_steps` launches it for CUDA tensors and runs the plain
twin `lattice_plasticity_steps_reference` for CPU tensors (the counterpart
of the TPU kernel's interpret mode).  A build or launch failure raises;
nothing falls back.

The closed loop (`interactable.JitEnvironment`; the TPU kernel's env form,
``_make_kernel(spec, n, env)`` driven by ``_env_advance``) takes one step
per launch of an `env_step_launcher` step, between callbacks that stay
PyTorch operations: its reward is a 0-dim device tensor and its clock a
1-element device tensor that the launch advances, and it writes into
buffers the caller owns, so that a CUDA graph of such steps replays on
the values the buffers hold.  On a GPU, launch k runs step k-1's edge pass
(deferred across the callbacks, from kernel-private copies of step k-1's
firing times and spike flags) and then step k; the launchers of one loop
share an `EnvChain`, whose `flush` runs the last step's edge pass.
`env_step_launcher` checks the buffers once and returns the launch of one
step (the C entry ``lattice_plasticity_env_step``);
`env_step_launcher_reference` is its plain twin, which runs each step
whole.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.plasticity import (kernel_exp, rstdp_visit, rule_floats,
                               rule_tensors, stdp_delta)
from ..models.base import NEVER
from ..utils import profiling

# Per-model parameter planes, in the kernel's order (the JAX kernel's).
MODEL_PARAM_KEYS = {
    "izhikevich": ("a", "b", "c", "d", "v_th", "gap_conductance",
                   "tau_m", "c_m", "dt"),
    "alif": ("v_th", "v_reset", "tref", "alpha", "beta", "leak_constant",
             "integration_constant", "gap_conductance", "e_l", "g_l",
             "tau_m", "c_m", "dt"),
    "lif": ("v_th", "v_reset", "tref", "leak_constant",
            "integration_constant", "gap_conductance", "e_l", "g_l",
            "tau_m", "dt"),
}
# models whose spike handler carries a refractory_count plane
REFRACTORY_MODELS = ("alif", "lif")
MODELS = tuple(MODEL_PARAM_KEYS)            # kernel model ids 0, 1, 2
KINDS = ("plain", "plastic", "mod")         # kernel kind ids 0, 1, 2
STDP_KEYS = ("a_plus", "a_minus", "tau_plus", "tau_minus", "dt")
MAX_OFFSETS = 64          # LP_MAX_OFFSETS in the CUDA source
STEPS_PER_LAUNCH = 16     # K of the runners' kernel calls

# Calls of `lattice_plasticity_steps` that launched the CUDA kernels.
LAUNCHES = 0
# The CUDA kernel launches those calls made, as the C entry counts them at
# each launch (`step_launches` per call when the schedule is as designed).
STEP_LAUNCHES = 0
# The closed loop's CUDA kernel launches, as the C entry counts them: at
# each launch outside a graph capture, and per replay of a captured graph
# the launches counted at its capture (added by the replaying runner).
ENV_LAUNCHES = 0


class KernelError(RuntimeError):
    """A CUDA kernel of this module failed to launch or to run."""


class LatSpec(NamedTuple):
    kind: str                  # 'plain' | 'plastic' | 'mod'
    model: str                 # MODEL_PARAM_KEYS key
    offsets: tuple             # stencil offsets ((dr, dc), ...)
    emit: bool = False         # emit each step's pre-reset v
    with_reward: bool = False  # dopamine takes a reward each step


def model_kind(model):
    """MODEL_PARAM_KEYS key of a supported neuron model, else None.
    `DopaIzhikevich` steps as `Izhikevich` does (only its receptors and
    defaults differ), so it is an Izhikevich kind."""
    from ..models.dopa import DopaIzhikevich
    from ..models.integrate_and_fire import (
        AdaptiveLeakyIntegrateAndFire, Izhikevich, LeakyIntegrateAndFire)
    return {Izhikevich: "izhikevich",
            DopaIzhikevich: "izhikevich",
            AdaptiveLeakyIntegrateAndFire: "alif",
            LeakyIntegrateAndFire: "lif"}.get(type(model))


def _stencil_ok(lat):
    from .graph import StencilGraph
    g = lat.graph
    return (isinstance(g, StencilGraph) and g.shape == (lat.rows, lat.cols)
            and len(g.offsets) <= MAX_OFFSETS)


def _single_lattice_ok(lat):
    if not (model_kind(lat.model) is not None and lat.electrical_synapse
            and not lat.chemical_synapse and _stencil_ok(lat)):
        return False
    with profiling.span("wait.nt_mask"):
        return not bool(lat.state["nt$mask"].any())


def supports_lattice(lat):
    """Whether the kernel runs a standalone `RewardModulatedLattice`."""
    from ..core.plasticity import RewardModulatedSTDP
    return (_single_lattice_ok(lat)
            and type(lat.reward_modulator) is RewardModulatedSTDP)


def supports_plain_lattice(lat):
    """Whether the kernel runs a standalone plain `Lattice` (kind
    ``plain``, or ``plastic`` with `STDP`): the closed loop's
    unsupervised form."""
    from ..core.plasticity import STDP
    return (_single_lattice_ok(lat)
            and (not lat.do_plasticity or type(lat.plasticity) is STDP))


def plain_stdp_lattice_spec(lat):
    """The spec of a plain `Lattice` with STDP, or None outside the
    kernel's class.  A grid history rides along as emitted pre-reset v,
    for Izhikevich only, as in the JAX package."""
    from ..core.plasticity import STDP
    if not _single_lattice_ok(lat) or type(lat.plasticity) is not STDP:
        return None
    mk = model_kind(lat.model)
    emit = bool(lat.update_grid_history)
    if emit and mk != "izhikevich":
        return None
    return LatSpec("plastic", mk, lat.graph.offsets, emit)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def _need(name, t, dtype, shp, dev):
    if t is None or t.dtype != dtype or tuple(t.shape) != tuple(shp) \
            or t.device != dev or not t.is_contiguous():
        got = None if t is None else (t.dtype, tuple(t.shape), t.device)
        raise ValueError(f"{name} must be a contiguous {dtype} "
                         f"{tuple(shp)} tensor on {dev}; got {got}")


def _check(spec, v, w, lft, refr, weights, mask, in_deg, params, traces,
           dopamine, rewards, clock0, n_steps):
    if spec.kind not in KINDS or spec.model not in MODEL_PARAM_KEYS:
        raise ValueError(f"no kernel for kind {spec.kind!r} and model "
                         f"{spec.model!r}")
    if v.dim() != 2:
        raise ValueError(f"v must be a (rows, cols) plane, got {tuple(v.shape)}")
    shape, dev = v.shape, v.device
    n_off = len(spec.offsets)

    def need(name, t, dtype, shp):
        _need(name, t, dtype, shp, dev)

    missing = [k for k in MODEL_PARAM_KEYS[spec.model] if k not in params]
    if missing:
        raise KeyError(f"missing parameter planes: {missing}")
    for name, t in [("v", v), ("w", w), ("in_deg", in_deg)] + [
            (k, params[k]) for k in MODEL_PARAM_KEYS[spec.model]]:
        need(name, t, torch.float32, shape)
    need("lft", lft, torch.int32, shape)
    if spec.model in REFRACTORY_MODELS:
        need("refr", refr, torch.float32, shape)
    need("weights", weights, torch.float32, (n_off, *shape))
    if spec.kind != "plain":
        need("mask", mask, torch.bool, (n_off, *shape))
    if spec.kind == "mod":
        if traces is None:
            raise ValueError("kind 'mod' needs the traces (c, dw, counter)")
        need("c", traces[0], torch.float32, (n_off, *shape))
        need("dw", traces[1], torch.float32, (n_off, *shape))
        need("counter", traces[2], torch.int32, (n_off, *shape))
    if spec.kind == "mod" or spec.with_reward:
        need("dopamine", dopamine, torch.float32, ())
    if spec.with_reward and spec.kind == "plastic":
        raise ValueError("the STDP kind 'plastic' takes no reward")
    if spec.with_reward and (rewards is None or len(rewards) != int(n_steps)):
        raise ValueError(f"with_reward needs {n_steps} rewards")
    if n_off > MAX_OFFSETS:
        raise ValueError(f"the kernel takes at most {MAX_OFFSETS} offsets, "
                         f"got {n_off}")
    if int(n_steps) < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if not -2**31 <= int(clock0) <= 2**31 - int(n_steps):
        raise ValueError(f"clock {clock0} + {n_steps} steps overflows int32")


def step_launches(spec, n_steps, per_step=False):
    """The CUDA kernel launches of one call of ``n_steps`` steps: K + 1
    (K for kind ``plain``); ``per_step``, a cell and an edge launch per
    step and a dopamine launch per 16 rewards."""
    n, plastic = int(n_steps), spec.kind != "plain"
    if not per_step:
        return n + plastic
    return n * (1 + plastic) + (-(-n // STEPS_PER_LAUNCH)
                                if spec.with_reward else 0)


# (model, kind) whose per-step design took less device time than the fused
# schedule, timed in turns by chip_smoke.py on an H100, and the least cells
# from which it did: STDP on ALIF at 512 x 512 (the fused schedule won at
# 128 x 128 and 256 x 256, and for every other model and kind at 512 x 512).
PER_STEP_FROM = {("alif", "plastic"): 512 * 512}


def per_step_route(spec, rows, cols):
    """Whether the runner takes the per-step design for ``spec`` on a
    ``rows`` x ``cols`` lattice (`PER_STEP_FROM`)."""
    least = PER_STEP_FROM.get((spec.model, spec.kind))
    return least is not None and rows * cols >= least


def lattice_plasticity_steps(spec, v, w, lft, refr, weights, mask, in_deg,
                             params, traces, dopamine, rule, rewards, clock0,
                             n_steps, _per_step=False, _own=False):
    """Advance ``n_steps`` steps of one lattice of ``spec``.

    ``v``, ``w`` (a zero plane for LIF), ``in_deg`` and the planes of
    ``params`` (keys ``MODEL_PARAM_KEYS[spec.model]``) are (rows, cols)
    float32; ``lft`` is int32; ``refr`` the float32 refractory count
    (ALIF and LIF, else None).  ``weights``, ``mask`` (bool) and the
    ``traces`` (c, dw float32, counter int32; kind ``mod``) are
    (n_off, rows, cols).  ``dopamine`` is a 0-dim float32 tensor (kind
    ``mod`` or ``with_reward``), ``rule`` the STDP or R-STDP parameter
    dict, ``rewards`` a host array of ``n_steps`` floats (``with_reward``).

    Returns ``(v, w, lft, refr, spikes, weights, traces, dopamine,
    v_pre)``: spikes are the last step's (bool), ``v_pre`` the
    (n_steps, rows, cols) pre-reset voltages when ``spec.emit``, else
    None.  The inputs are not modified: weights and traces are copied once
    per call and updated in place in the copy (``_own``: a runner's own
    copy, updated in place on CUDA).  ``_per_step`` takes the per-step
    design on CUDA (the same bits): the runner's route where
    `per_step_route` says so, and the smoke's comparison.
    """
    with profiling.span("plasticity.call"):
        return _plasticity_steps(
            spec, v, w, lft, refr, weights, mask, in_deg, params, traces,
            dopamine, rule, rewards, clock0, n_steps, _per_step, _own)


def _plasticity_steps(spec, v, w, lft, refr, weights, mask, in_deg, params,
                      traces, dopamine, rule, rewards, clock0, n_steps,
                      _per_step, _own):
    global LAUNCHES, STEP_LAUNCHES
    _check(spec, v, w, lft, refr, weights, mask, in_deg, params, traces,
           dopamine, rewards, clock0, n_steps)
    if v.device.type == "cpu":
        return lattice_plasticity_steps_reference(
            spec, v, w, lft, refr, weights, mask, in_deg, params, traces,
            dopamine, rule, rewards, clock0, n_steps)
    if v.device.type != "cuda":
        raise ValueError(f"no kernel for device {v.device}")
    from .. import _build
    lib = _build.load()
    rows, cols = v.shape
    n_steps, n_off = int(n_steps), len(spec.offsets)
    dev = v.device
    refractory = spec.model in REFRACTORY_MODELS
    bufs = [torch.empty((2, rows, cols), dtype=torch.float32, device=dev),
            torch.empty((2, rows, cols), dtype=torch.float32, device=dev),
            torch.empty((2, rows, cols), dtype=torch.int32, device=dev),
            torch.empty((2, rows, cols), dtype=torch.float32, device=dev)
            if refractory else None]
    spikes = torch.empty((2, rows, cols), dtype=torch.bool, device=dev)
    v_pre = torch.empty((n_steps, rows, cols), dtype=torch.float32,
                        device=dev) if spec.emit else None
    if spec.kind != "plain" and not _own:
        weights = weights.clone()
    if spec.kind == "mod" and not _own:
        traces = tuple(t.clone() for t in traces)
    dop_steps = torch.empty(n_steps, dtype=torch.float32, device=dev) \
        if spec.with_reward else None
    r = rule_floats(rule)
    rule_vec = (ctypes.c_float * 9)(*[
        r.get(k, 0.0)
        for k in STDP_KEYS + ("tau_c", "exp_dc", "tau_d", "exp_dd")])
    rew = (ctypes.c_float * n_steps)(
        *np.asarray(rewards, np.float32).tolist()) \
        if spec.with_reward else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    state_in = (ctypes.c_void_p * 4)(ptr(v), ptr(w), ptr(lft), ptr(refr))
    state_buf = (ctypes.c_void_p * 8)(
        *[None if b is None else b[0].data_ptr() for b in bufs],
        *[None if b is None else b[1].data_ptr() for b in bufs])
    keys = MODEL_PARAM_KEYS[spec.model]
    param_ptrs = (ctypes.c_void_p * len(keys))(
        *[params[k].data_ptr() for k in keys])
    dr = (ctypes.c_int * max(n_off, 1))(*[o[0] for o in spec.offsets])
    dc = (ctypes.c_int * max(n_off, 1))(*[o[1] for o in spec.offsets])
    c_, dw_, ct_ = traces if spec.kind == "mod" else (None, None, None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.lattice_plasticity_steps(
            MODELS.index(spec.model), KINDS.index(spec.kind),
            int(spec.with_reward), state_in, state_buf, ptr(spikes),
            ptr(v_pre), ptr(in_deg), param_ptrs, len(keys), ptr(weights),
            ptr(mask) if spec.kind != "plain" else None,
            ptr(c_), ptr(dw_), ptr(ct_),
            ptr(dopamine), ptr(dop_steps), rule_vec, rew,
            dr, dc, n_off, rows, cols, int(clock0), n_steps,
            int(bool(_per_step)), ctypes.byref(launched), stream)
    if rc != 0:
        raise RuntimeError(f"lattice_plasticity_steps failed with CUDA error "
                           f"{rc} ({torch.cuda.get_device_name(dev)})")
    LAUNCHES += 1
    STEP_LAUNCHES += launched.value
    last = (n_steps - 1) % 2
    return (bufs[0][last], bufs[1][last], bufs[2][last],
            bufs[3][last] if refractory else None, spikes[last], weights,
            traces,
            dop_steps[-1] if spec.with_reward else dopamine, v_pre)


# ---------------------------------------------------------------------------
# Plain twin
# ---------------------------------------------------------------------------


def model_step(model, p, v, w, refr, i_syn, rec_dv=None):
    """Phase B of one model in the kernels' association (the plasticity
    and the network twins share it): returns the new (v, w, refr), the
    spikes and the pre-reset voltage ``v + dv`` (``v + dv - rec_dv`` with
    the receptors' ``rec_dv``)."""
    if model == "izhikevich":
        dt_cm = p["dt"] / p["c_m"]
        dt_tau = p["dt"] / p["tau_m"]
        dv = (0.04 * v * v + 5.0 * v + 140.0 - w + i_syn) * dt_cm
        dw = (p["a"] * (p["b"] * v - w)) * dt_tau
        v_pre = v + dv if rec_dv is None else v + dv - rec_dv
        w_new = w + dw
        spk = v_pre >= p["v_th"]
        return (torch.where(spk, p["c"], v_pre),
                torch.where(spk, w_new + p["d"], w_new), refr, spk, v_pre)
    dt_tau = p["dt"] / p["tau_m"]
    leak = p["leak_constant"] * (v - p["e_l"])
    drive = p["integration_constant"] * (i_syn / p["g_l"])
    if model == "alif":
        dv = (leak + drive - w / p["g_l"]) * (p["dt"] / p["c_m"])
        w_new = w + (p["alpha"] * (v - p["e_l"]) - w) * dt_tau
    else:
        dv = (leak + drive) * dt_tau
        w_new = w
    v_pre = v + dv if rec_dv is None else v + dv - rec_dv
    in_ref = refr > 0.0
    spk = torch.logical_and(torch.logical_not(in_ref), v_pre >= p["v_th"])
    v_new = torch.where(torch.logical_or(in_ref, spk), p["v_reset"], v_pre)
    if model == "alif":
        w_new = torch.where(spk, w_new + p["beta"], w_new)
    refr = torch.where(in_ref, refr - 1.0,
                       torch.where(spk, p["tref"] / p["dt"], refr))
    return v_new, w_new, refr, spk, v_pre


def shifted(x, offsets, fill):
    """out[o][r, c] = x[r + dr_o, c + dc_o], ``fill`` off the grid: the
    twins' shifted reads, as slices of a padded plane."""
    rows, cols = x.shape
    pad = max([max(abs(dr), abs(dc)) for dr, dc in offsets], default=0)
    xp = F.pad(x, (pad, pad, pad, pad), value=fill)
    return [xp[pad + dr:pad + dr + rows, pad + dc:pad + dc + cols]
            for dr, dc in offsets]


def _twin_step(spec, p, cnt, r, v, w, lft, refr, weights, masks, tr, dop,
               reward, clock):
    """One step of the twin: phase A, the dopamine (``reward`` a 0-dim
    float32 tensor, or None), phase B with ``lft = clock`` on a spike
    (``clock`` an int or a 0-dim int32 tensor), then the plasticity of
    ``spec.kind``.  ``weights``, ``masks`` and the trace lists ``tr`` hold
    one plane per offset; the updated planes replace theirs in the lists.
    Returns ``(v, w, lft, refr, spikes, v_pre, dop)``."""
    offsets = spec.offsets
    acc = torch.zeros_like(v)
    wsum = torch.zeros_like(v)
    for o, vs in enumerate(shifted(v, offsets, 0.0)):
        acc = acc + weights[o] * vs
        wsum = wsum + weights[o]
    i_syn = p["gap_conductance"] * (acc - v * wsum) / cnt
    if reward is not None:
        dop = dop * r["exp_dd"] + r["tau_d"] * reward
    v, w, refr, spk, v_pre = model_step(spec.model, p, v, w, refr, i_syn)
    lft = lft.masked_fill(spk, clock) if isinstance(clock, int) \
        else torch.where(spk, clock, lft)
    if spec.kind == "plain":
        return v, w, lft, refr, spk, v_pre, dop
    lft_pre = shifted(lft, offsets, NEVER)
    if spec.kind == "plastic":
        spk_f = spk.to(torch.float32)
        for o, sp in enumerate(shifted(spk_f, offsets, 0.0)):
            delta = stdp_delta(lft_pre[o], lft, r, kernel_exp)
            weights[o] = torch.where(masks[o],
                                     weights[o] + delta * (sp + spk_f),
                                     weights[o])
        return v, w, lft, refr, spk, v_pre, dop
    tc, tdw, tct = tr
    for o in range(len(offsets)):
        delta = stdp_delta(lft_pre[o], lft, r, kernel_exp)
        w1, c1, d1, t1 = rstdp_visit(weights[o], tc[o], tdw[o], tct[o],
                                     delta, dop, r)
        w2, c2, d2, t2 = rstdp_visit(w1, c1, d1, t1, delta, dop, r)
        m = masks[o]
        weights[o] = torch.where(m, w2, weights[o])
        tc[o] = torch.where(m, c2, tc[o])
        tdw[o] = torch.where(m, d2, tdw[o])
        tct[o] = torch.where(m, t2, tct[o])
    return v, w, lft, refr, spk, v_pre, dop


def lattice_plasticity_steps_reference(spec, v, w, lft, refr, weights, mask,
                                       in_deg, params, traces, dopamine,
                                       rule, rewards, clock0, n_steps):
    """The plain PyTorch twin of the CUDA kernels, on any device.

    Same association and offset order as the kernels (and as the TPU
    kernel), and the kernels' exp (`core.plasticity.kernel_exp`), so the
    twin and the kernels agree bit for bit on any device.  Shifted reads
    are slices of padded planes: v pads with 0 (an off-grid neighbour adds
    ``w * 0``), lft with NEVER and spikes with 0 (an off-grid neighbour
    gives a zero delta), which is what the kernels' bounds checks do.
    """
    dev = v.device
    r = rule_tensors(rule, dev)
    p = {k: params[k] for k in MODEL_PARAM_KEYS[spec.model]}
    cnt = torch.clamp(in_deg, min=1.0)
    ws = list(weights.unbind(0))
    masks = list(mask.unbind(0)) if spec.kind != "plain" else None
    tr = tuple(list(t.unbind(0)) for t in traces) \
        if spec.kind == "mod" else None
    dop = dopamine
    v_pres, spk = [], None
    for k in range(int(n_steps)):
        reward = torch.tensor(float(np.float32(rewards[k])),
                              dtype=torch.float32, device=dev) \
            if spec.with_reward else None
        v, w, lft, refr, spk, v_pre, dop = _twin_step(
            spec, p, cnt, r, v, w, lft, refr, ws, masks, tr, dop, reward,
            int(clock0) + k)
        if spec.emit:
            v_pres.append(v_pre)
    if spec.kind != "plain":
        weights = torch.stack(ws)
    if spec.kind == "mod":
        traces = tuple(torch.stack(t) for t in tr)
    return (v, w, lft, refr, spk, weights, traces, dop,
            torch.stack(v_pres) if spec.emit else None)


# ---------------------------------------------------------------------------
# The closed loop's one-step entry
# ---------------------------------------------------------------------------


def _check_env(spec, src, dst, spikes, weights, mask, in_deg, params, traces,
               dopamine, clock):
    v = src[0]
    _check(spec._replace(with_reward=False), *src, weights, mask, in_deg,
           params, traces, dopamine, None, 0, 1)
    shape, dev = tuple(v.shape), v.device

    def need(name, t, dtype, shp):
        _need(name, t, dtype, shp, dev)

    for name, t, dtype in (("v out", dst[0], torch.float32),
                           ("w out", dst[1], torch.float32),
                           ("lft out", dst[2], torch.int32)):
        need(name, t, dtype, shape)
    if spec.model in REFRACTORY_MODELS:
        need("refr out", dst[3], torch.float32, shape)
    for a, b in zip(src, dst):
        if a is not None and b is not None and a.data_ptr() == b.data_ptr():
            raise ValueError("the step's input and output planes must be "
                             "distinct tensors")
    need("spikes", spikes, torch.bool, shape)
    need("clock", clock, torch.int32, (1,))
    if spec.with_reward:
        if spec.kind == "plastic":
            raise ValueError("the STDP kind 'plastic' takes no reward")
        need("dopamine", dopamine, torch.float32, ())


def _check_reward(spec, reward, dev):
    """A launch's reward: a 0-dim float32 tensor on the buffers' device
    (with a reward only; the CUDA kernels read it through its pointer)."""
    if spec.with_reward:
        _need("reward", reward, torch.float32, (), dev)


class EnvLaunch(NamedTuple):
    """The buffers one closed-loop launch reads and writes (`EnvChain.
    launch`): ``edge``, step k-1's edge pass from the kept planes
    ``lft_edge``, ``spk_edge`` and the dopamine ``dop_read``; ``cell``,
    step k at the clock ``clock_read``, its firing times and spike flags
    kept in ``lft_keep``, ``spk_keep``.  Block 0 writes the dopamine (step
    k's reward folded in, with a reward) to ``dop_write`` and the clock
    (+ 1 with ``cell``) to ``clock_write``, where not None."""
    edge: bool
    cell: bool
    lft_keep: object
    spk_keep: object
    lft_edge: object
    spk_edge: object
    dop_read: object
    dop_write: object
    clock_read: object
    clock_write: object


class EnvChain:
    """What the CUDA launches of one closed loop share from step to step
    (`env_step_launcher`'s ``chain``): the step whose edge pass is still
    due, the parity p of the steps since the last flush, the kernel-private
    planes of the firing times and spike flags that step k keeps in plane
    k % 2 for its deferred edge pass (a callback may write the state
    planes in between), and a second slot of the dopamine and of the
    clock.  Slot 0 is the caller's ``dopamine`` (0-dim float32; None
    without one) and ``clock`` (1-element int32); launch k reads slot p
    and writes slot 1 - p.  `flush` runs the last step's edge pass and
    moves the scalars back into slot 0, so that after it the caller's
    buffers hold the whole state: K + 1 launches per K steps with
    plasticity, K without (K even).  ``per_step`` flushes after every
    step instead (the design without the deferral: two launches a step),
    to compare the two."""

    def __init__(self, dopamine, clock, shape, per_step=False):
        dev = clock.device
        self.dop = (dopamine, None if dopamine is None
                    else torch.zeros((), dtype=torch.float32, device=dev))
        self.clock = (clock, torch.zeros(1, dtype=torch.int32, device=dev))
        self.lft = torch.full((2, *shape), NEVER, dtype=torch.int32,
                              device=dev)
        self.spk = torch.zeros((2, *shape), dtype=torch.bool, device=dev)
        self.due = None          # (run, plastic) of the step launched last
        self.parity = 0
        self.per_step = per_step
        self.launched = 0        # kernel launches, as the C entry counted

    def buffers(self):
        """The private buffers (for a snapshot that must restore them)."""
        return [x for x in (self.dop[1], self.clock[1], self.lft, self.spk)
                if x is not None]

    def launch(self, cell, plastic):
        """The `EnvLaunch` of the next step (``cell``) or of a flush."""
        p = self.parity
        to = 1 - p if cell else 0
        write = cell or p == 1
        return EnvLaunch(
            edge=self.due is not None and plastic, cell=cell,
            lft_keep=self.lft[p] if cell else None,
            spk_keep=self.spk[p] if cell else None,
            lft_edge=self.lft[1 - p], spk_edge=self.spk[1 - p],
            dop_read=self.dop[p],
            dop_write=self.dop[to] if write else None,
            clock_read=self.clock[p],
            clock_write=self.clock[to] if write else None)

    def step(self, run, plastic, reward):
        """Launch the next step through ``run(EnvLaunch, reward)``."""
        run(self.launch(True, plastic), reward)
        self.due = (run, plastic)
        self.parity ^= 1
        if self.per_step:
            self.flush()

    def flush(self):
        """Run the due edge pass and settle the scalars in slot 0 (nothing
        when no step is due)."""
        if self.due is not None:
            run, plastic = self.due
            if plastic or self.parity:
                run(self.launch(False, plastic), None)
        self.reset()

    def reset(self):
        """Forget the due step (after its buffers were restored)."""
        self.due = None
        self.parity = 0


def env_step_launcher(spec, src, dst, spikes, weights, mask, in_deg, params,
                      traces, dopamine, rule, clock, chain=None):
    """Check the buffers of one closed-loop step once, and return
    ``launch(reward)``, which advances one step from the planes ``src`` =
    (v, w, lft, refr) into ``dst`` (refr None for Izhikevich; w a zero
    plane for LIF) and ``spikes`` (bool), updates ``weights`` and the
    ``traces`` (c, dw, counter; kind ``mod``) in place, with a reward
    (``spec.with_reward``) the 0-dim ``dopamine`` in place from the 0-dim
    float32 device tensor ``reward``, and advances the 1-element int32
    ``clock``.  Shapes and types are those of `lattice_plasticity_steps`.
    On CUDA tensors each launch runs the CUDA kernel on the current
    stream, after the edge pass of the step ``chain`` (the `EnvChain` of
    ``dopamine``, ``clock`` and the planes' shape that the launchers of one
    loop share) launched before: the weights, traces, dopamine and clock
    are the whole step's after ``chain.flush()``.  Its launches are
    counted in `ENV_LAUNCHES` unless the stream is being captured.  On CPU tensors the launch is the plain
    twin's, `env_step_launcher_reference`, which runs each step whole.  A
    launch failure raises `KernelError`."""
    dev = src[0].device
    if dev.type == "cpu":
        return env_step_launcher_reference(spec, src, dst, spikes, weights,
                                           mask, in_deg, params, traces,
                                           dopamine, rule, clock)
    _check_env(spec, src, dst, spikes, weights, mask, in_deg, params, traces,
               dopamine, clock)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    dop = dopamine if spec.kind == "mod" or spec.with_reward else None
    if chain is None:
        raise ValueError("the CUDA launcher needs the EnvChain that the "
                         "launchers of its loop share")
    if chain.clock[0] is not clock \
            or (dop is not None and chain.dop[0] is not dop) \
            or tuple(chain.lft.shape[1:]) != tuple(src[0].shape):
        raise ValueError("the chain must hold this launcher's clock, its "
                         "dopamine (kinds with one) and its planes' shape")
    from .. import _build
    lib = _build.load()
    rows, cols = src[0].shape
    n_off = len(spec.offsets)
    plastic = spec.kind != "plain"

    def ptr(t):
        return None if t is None else t.data_ptr()

    r = rule_floats(rule)
    keys = MODEL_PARAM_KEYS[spec.model]
    c_, dw_, ct_ = traces if spec.kind == "mod" else (None, None, None)
    # built once: the ctypes arrays and the pointers of the state
    model, kind = MODELS.index(spec.model), KINDS.index(spec.kind)
    planes = ((ctypes.c_void_p * 4)(*map(ptr, src)),
              (ctypes.c_void_p * 4)(*map(ptr, dst)), ptr(spikes))
    consts = (ptr(in_deg), (ctypes.c_void_p * len(keys))(
        *[params[k].data_ptr() for k in keys]), len(keys), ptr(weights),
        ptr(mask) if plastic else None, ptr(c_), ptr(dw_), ptr(ct_))
    tail = ((ctypes.c_float * 9)(*[
        r.get(k, 0.0)
        for k in STDP_KEYS + ("tau_c", "exp_dc", "tau_d", "exp_dd")]),
        (ctypes.c_int * max(n_off, 1))(*[o[0] for o in spec.offsets]),
        (ctypes.c_int * max(n_off, 1))(*[o[1] for o in spec.offsets]),
        n_off, rows, cols)

    def run(how, reward):
        global ENV_LAUNCHES
        launched = ctypes.c_int(0)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            rc = lib.lattice_plasticity_env_step(
                model, kind, int(how.edge), int(how.cell),
                *(planes if how.cell else (None, None, None)),
                ptr(how.lft_keep), ptr(how.spk_keep), ptr(how.lft_edge),
                ptr(how.spk_edge), *consts, ptr(how.dop_read),
                ptr(how.dop_write), ptr(reward), ptr(how.clock_read),
                ptr(how.clock_write), *tail, ctypes.byref(launched),
                stream.cuda_stream)
            if rc != 0:
                raise KernelError(
                    f"lattice_plasticity_env_step failed with CUDA error "
                    f"{rc} ({torch.cuda.get_device_name(dev)})")
            chain.launched += launched.value
            if not torch.cuda.is_current_stream_capturing():
                ENV_LAUNCHES += launched.value

    def launch(reward=None):
        _check_reward(spec, reward, dev)
        chain.step(run, plastic, reward if spec.with_reward else None)

    return launch


def env_step_launcher_reference(spec, src, dst, spikes, weights, mask,
                                in_deg, params, traces, dopamine, rule,
                                clock):
    """The plain twin of `env_step_launcher`, on any device: the same
    checks, and a launch that runs the twin's step."""
    _check_env(spec, src, dst, spikes, weights, mask, in_deg, params, traces,
               dopamine, clock)
    dev = src[0].device
    r = rule_tensors(rule, dev)
    p = {k: params[k] for k in MODEL_PARAM_KEYS[spec.model]}
    masks = list(mask.unbind(0)) if spec.kind != "plain" else None

    def launch(reward=None):
        _check_reward(spec, reward, dev)
        # read from the buffers at each launch, as the kernels read them
        cnt = torch.clamp(in_deg, min=1.0)
        ws = list(weights.unbind(0))
        tr = tuple(list(t.unbind(0)) for t in traces) \
            if spec.kind == "mod" else None
        dop = dopamine if spec.kind == "mod" or spec.with_reward else None
        out = _twin_step(spec, p, cnt, r, *src, ws, masks, tr, dop,
                         reward if spec.with_reward else None, clock[0])
        for t, x in zip(dst, out[:4]):
            if t is not None:
                t.copy_(x)
        spikes.copy_(out[4])
        if spec.with_reward:
            dopamine.copy_(out[6])
        if spec.kind != "plain":
            weights.copy_(torch.stack(ws))
        if spec.kind == "mod":
            for t, x in zip(traces, tr):
                t.copy_(torch.stack(x))
        clock.add_(1)

    return launch


# ---------------------------------------------------------------------------
# Runner: K-step calls over a lattice's state
# ---------------------------------------------------------------------------


def advance(spec, state, graph, trace, dopamine, rule, rewards, clock,
            length, shape):
    """``length`` steps of a lattice's state through K-step wrapper calls.

    ``state`` is the flat per-neuron dict, ``graph`` its `StencilGraph`,
    ``trace`` the R-STDP trace dict (kind ``mod``), ``dopamine`` a 0-dim
    float32 tensor on the state's device, ``rewards`` a host array of
    ``length`` floats (``spec.with_reward``).  Returns ``(state, weights,
    trace, dopamine, v_pre)`` with ``v_pre`` the (length, rows, cols)
    pre-reset voltages when ``spec.emit``, else None.  The weights and
    traces are copied once per run; the calls update the copy in place.
    The design is `per_step_route`'s.
    """
    st = state
    refractory = spec.model in REFRACTORY_MODELS
    with profiling.span("reward.setup"):
        params = {k: st[k].reshape(shape)
                  for k in MODEL_PARAM_KEYS[spec.model]}
        v = st["v"].reshape(shape)
        w = st["w"].reshape(shape) if "w" in st else \
            torch.zeros(shape, dtype=torch.float32, device=v.device)
        lft = st["last_firing_time"].reshape(shape)
        refr = st["refractory_count"].reshape(shape) if refractory else None
        traces = tuple(trace[k].clone() for k in ("c", "dw", "counter")) \
            if spec.kind == "mod" else None
        weights = graph.weights.clone() if spec.kind != "plain" \
            else graph.weights
    emits, spikes = [], None
    done, per_step = 0, per_step_route(spec, *shape)
    while done < length:
        n = min(STEPS_PER_LAUNCH, length - done)
        (v, w, lft, refr, spikes, weights, traces, dopamine,
         v_pre) = lattice_plasticity_steps(
            spec, v, w, lft, refr, weights, graph.mask, graph.in_deg, params,
            traces, dopamine, rule,
            rewards[done:done + n] if spec.with_reward else None,
            clock + done, n, _per_step=per_step, _own=True)
        if spec.emit:
            emits.append(v_pre)
        done += n
    st = dict(st)
    st["v"] = v.reshape(-1)
    if "w" in st:
        st["w"] = w.reshape(-1)
    st["last_firing_time"] = lft.reshape(-1)
    st["is_spiking"] = spikes.reshape(-1)
    if refractory:
        st["refractory_count"] = refr.reshape(-1)
    if spec.kind == "mod":
        trace = dict(c=traces[0], dw=traces[1], counter=traces[2])
    return st, weights, trace, dopamine, \
        torch.cat(emits) if spec.emit else None

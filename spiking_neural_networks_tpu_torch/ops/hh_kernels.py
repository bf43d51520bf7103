"""The Hodgkin-Huxley chemical lattice kernel: wrapper, plain twin and gate.

PyTorch/CUDA counterpart of ``spiking_neural_networks_tpu/ops/pallas_hh.py``
(`fused_hh_multistep`): K steps of a Hodgkin-Huxley lattice with
Ionotropic receptors (AMPA, NMDA, GABA) on a stencil graph, where each step
runs, in this order,

1. the electrical input ``gap * (acc - v * wsum) / max(in_deg, 1)`` from
   the current weights (with electrical synapses on);
2. the chemical input per type: ``sums / max(cnts, 1)`` with ``sums =
   sum_o w_o * t[r+dr, c+dc] * m[r+dr, c+dc]`` and ``cnts = sum_o mask_o *
   m[r+dr, c+dc]`` (``m`` the presence mask), valid where ``cnts > 0``;
3. receptor kinetics (Destexhe or approximate) on valid, inserted slots,
   then the AMPA / NMDA (Mg block) / GABA currents at the pre-update v;
4. the Na, K and K-leak gates from the old v, and the Euler step
   ``v += dt * (i_elec - (i_na + i_k + i_kl)) / c_m - i_ligand``;
5. neurotransmitter release (Destexhe from the new v; approximate from the
   previous step's spike flag);
6. peak-detection spikes (above threshold, was rising, stopped rising) and
   ``lft = clock0 + k`` on a spike;
7. with STDP, ``w += delta(lft_pre, lft_post) * (spk_pre + spk_post)`` on
   every masked slot, from the post-step firing times and spikes.

On a GPU this is one hand-written CUDA kernel, ``csrc/hh_chemical.cu``
(plus the STDP edge kernel of ``csrc/lattice_plasticity.cu``): with STDP,
launch k runs step k-1's STDP pass and then step k, and an edge launch
follows the last step (K + 1 launches per K-step call; the internal
``_per_step=True`` takes the earlier design, an edge launch after every
step, for comparison);
`hh_steps` launches it for CUDA tensors and runs the plain twin
`hh_steps_reference` for CPU tensors (the counterpart of the TPU kernel's
interpret mode).  A build or launch failure raises; nothing falls back.

Per-neuron fields keep the state dict's layout: (N,) planes and (N, 3)
per-type arrays, N = rows * cols in row-major order.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.plasticity import kernel_exp, rule_floats, rule_tensors, stdp_delta
from ..models.base import NEVER
from .kinetics import nt_release, rec_kinetics
from .reward_kernels import shifted

# per-neuron parameter planes, in the kernel's order (the TPU kernel's)
PARAM_ORDER = ("dt", "c_m", "v_th", "gap_conductance",
               "na$g", "na$e", "k$g", "k$e", "kleak$g", "kleak$e")
# the fields a step carries to the next, in the kernel's order
STATE_KEYS = ("v", "na$m_state", "na$h_state", "k$n_state", "was_increasing",
              "is_spiking", "last_firing_time", "nt$t", "rec$r")
# the last step's currents
CURRENT_KEYS = ("rec$current", "na$current", "k$current", "kleak$current")
KINETICS = ("destexhe", "approximate")      # kernel kinetics ids 0, 1
STDP_KEYS = ("a_plus", "a_minus", "tau_plus", "tau_minus", "dt")
MAX_OFFSETS = 64          # LP_MAX_OFFSETS in the CUDA source
STEPS_PER_LAUNCH = 16     # K of the lattice runner's kernel calls
N_TYPES = 3               # AMPA, NMDA, GABA

# Calls of `hh_steps` that launched the CUDA kernels.
LAUNCHES = 0
# The CUDA kernel launches those calls made, as the C entry counts them at
# each launch (`step_launches` per call when the schedule is as designed).
STEP_LAUNCHES = 0


def step_launches(n_steps, plastic, per_step=False):
    """The CUDA kernel launches of one call of ``n_steps`` steps: K, and
    with STDP K + 1 (``per_step``: 2 K)."""
    n = int(n_steps)
    return n + (0 if not plastic else n if per_step else 1)


def nt_param_keys(kind):
    """The neurotransmitter parameters of ``kind``, in the kernel's order."""
    if kind == "destexhe":
        return ("nt$t_max", "nt$v_p", "nt$k_p")
    return ("nt$t_max", "nt$clearance_constant")


def rec_param_keys(kind):
    """The receptor parameters of ``kind``: the gating kinetics', then the
    currents' (g, e, mg)."""
    if kind == "destexhe":
        return ("rec$alpha", "rec$beta", "rec$g", "rec$e", "rec$mg")
    return ("rec$g", "rec$e", "rec$mg")


def supports(model, graph, chemical, do_plasticity, plasticity):
    """Whether the kernel computes this lattice configuration's step.  The
    electrical switch is not gated: the kernel takes both settings."""
    from ..core.plasticity import STDP
    from ..models.hodgkin_huxley import HodgkinHuxley
    from .graph import StencilGraph
    from .receptors import IonotropicReceptors
    return (type(model) is HodgkinHuxley
            and type(model.receptors) is IonotropicReceptors
            and model.nt_kinetics in KINETICS
            and model.rec_kinetics in KINETICS
            # the receptors' kinetics parameters are the model's
            and model.receptors.kinetics == model.rec_kinetics
            and chemical and isinstance(graph, StencilGraph)
            and len(graph.offsets) <= MAX_OFFSETS
            and (not do_plasticity or type(plasticity) is STDP))


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def _check(state, weights, mask, in_deg, offsets, clock0, n_steps, nt_kind,
           rec_kind):
    if nt_kind not in KINETICS or rec_kind not in KINETICS:
        raise ValueError(f"no kernel for kinetics {nt_kind!r} / {rec_kind!r}")
    if in_deg.dim() != 2:
        raise ValueError(f"in_deg must be a (rows, cols) plane, got "
                         f"{tuple(in_deg.shape)}")
    shape, dev = tuple(in_deg.shape), in_deg.device
    n, n_off = shape[0] * shape[1], len(offsets)

    def need(name, t, dtype, shp):
        if t is None or t.dtype != dtype or tuple(t.shape) != shp \
                or t.device != dev or not t.is_contiguous():
            got = None if t is None else (t.dtype, tuple(t.shape), t.device)
            raise ValueError(f"{name} must be a contiguous {dtype} {shp} "
                             f"tensor on {dev}; got {got}")

    f32 = torch.float32
    for k in PARAM_ORDER + STATE_KEYS[:4]:
        need(k, state.get(k), f32, (n,))
    need("was_increasing", state.get("was_increasing"), torch.bool, (n,))
    need("is_spiking", state.get("is_spiking"), torch.bool, (n,))
    need("last_firing_time", state.get("last_firing_time"), torch.int32,
         (n,))
    for k in ("nt$t", "rec$r") + nt_param_keys(nt_kind) \
            + rec_param_keys(rec_kind):
        need(k, state.get(k), f32, (n, N_TYPES))
    need("nt$mask", state.get("nt$mask"), torch.bool, (n, N_TYPES))
    need("rec$mask", state.get("rec$mask"), torch.bool, (n, N_TYPES))
    need("in_deg", in_deg, f32, shape)
    need("weights", weights, f32, (n_off, *shape))
    need("mask", mask, torch.bool, (n_off, *shape))
    if n_off > MAX_OFFSETS:
        raise ValueError(f"the kernel takes at most {MAX_OFFSETS} offsets, "
                         f"got {n_off}")
    if int(n_steps) < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if not -2**31 <= int(clock0) <= 2**31 - int(n_steps):
        raise ValueError(f"clock {clock0} + {n_steps} steps overflows int32")


def hh_steps(state, weights, mask, in_deg, offsets, clock0, n_steps,
             electrical, nt_kind, rec_kind, rule=None, _per_step=False,
             _own=False):
    """Advance ``n_steps`` Hodgkin-Huxley chemical steps of a (rows, cols)
    lattice.

    ``state`` is the flat per-neuron dict: the `STATE_KEYS`, the
    `PARAM_ORDER` planes, the kinetics' ``nt$`` and ``rec$`` parameters
    (`nt_param_keys`, `rec_param_keys`) and ``nt$mask`` / ``rec$mask``, as
    (N,) or (N, 3) tensors.  ``weights`` (float32) and ``mask`` (bool) are
    the (len(offsets), rows, cols) stencil planes, ``in_deg`` the
    (rows, cols) float32 in-degree.  ``rule`` is the STDP parameter dict, or
    None without plasticity.

    Returns ``(state, weights)``: a new dict with the `STATE_KEYS` after the
    last step and the `CURRENT_KEYS` of the last step, and the weights (a
    copy updated by STDP, or ``weights`` itself).  The inputs are not
    modified (``_own``: the weights are a runner's own copy, updated in
    place on CUDA).  ``_per_step`` takes the per-step design on CUDA (the
    same bits), so that the two can be timed against each other.
    """
    global LAUNCHES, STEP_LAUNCHES
    _check(state, weights, mask, in_deg, offsets, clock0, n_steps, nt_kind,
           rec_kind)
    if in_deg.device.type == "cpu":
        return hh_steps_reference(state, weights, mask, in_deg, offsets,
                                  clock0, n_steps, electrical, nt_kind,
                                  rec_kind, rule)
    if in_deg.device.type != "cuda":
        raise ValueError(f"no kernel for device {in_deg.device}")
    from .. import _build
    lib = _build.load()
    rows, cols = in_deg.shape
    n, n_steps, n_off = rows * cols, int(n_steps), len(offsets)
    dev = in_deg.device
    f32, b8, i32 = torch.float32, torch.bool, torch.int32
    bufs = [torch.empty((2, n), dtype=dt, device=dev)
            for dt in (f32, f32, f32, f32, b8, b8, i32)]
    bufs += [torch.empty((2, n, N_TYPES), dtype=f32, device=dev)
             for _ in range(2)]
    currents = [torch.empty((n, N_TYPES), dtype=f32, device=dev)] + [
        torch.empty(n, dtype=f32, device=dev) for _ in range(3)]
    plastic = rule is not None
    if plastic:
        if not _own:
            weights = weights.clone()
        r = rule_floats(rule)
        rule_vec = (ctypes.c_float * 5)(*[r[k] for k in STDP_KEYS])
    else:
        rule_vec = (ctypes.c_float * 5)()

    def ptrs(tensors):
        return (ctypes.c_void_p * len(tensors))(
            *[t.data_ptr() for t in tensors])

    ntk, reck = nt_param_keys(nt_kind), rec_param_keys(rec_kind)
    dr = (ctypes.c_int * max(n_off, 1))(*[o[0] for o in offsets])
    dc = (ctypes.c_int * max(n_off, 1))(*[o[1] for o in offsets])
    stream = torch.cuda.current_stream(dev).cuda_stream
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.hh_chemical_steps(
            KINETICS.index(nt_kind), KINETICS.index(rec_kind),
            int(bool(electrical)), int(plastic),
            ptrs([state[k] for k in STATE_KEYS]),
            ptrs([b[0] for b in bufs] + [b[1] for b in bufs]),
            ptrs(currents), ptrs([state[k] for k in PARAM_ORDER]),
            ptrs([state[k] for k in ntk]), len(ntk),
            ptrs([state[k] for k in reck]), len(reck),
            state["nt$mask"].data_ptr(), state["rec$mask"].data_ptr(),
            weights.data_ptr(), mask.data_ptr(), in_deg.data_ptr(),
            rule_vec, dr, dc, n_off, rows, cols, int(clock0), n_steps,
            int(bool(_per_step)), ctypes.byref(launched), stream)
    if rc != 0:
        raise RuntimeError(f"hh_chemical_steps failed with CUDA error {rc} "
                           f"({torch.cuda.get_device_name(dev)})")
    LAUNCHES += 1
    STEP_LAUNCHES += launched.value
    last = (n_steps - 1) % 2
    out = dict(state)
    out.update((k, b[last]) for k, b in zip(STATE_KEYS, bufs))
    out.update(zip(CURRENT_KEYS, currents))
    return out, weights


# ---------------------------------------------------------------------------
# Plain twin
# ---------------------------------------------------------------------------


def hh_steps_reference(state, weights, mask, in_deg, offsets, clock0,
                       n_steps, electrical, nt_kind, rec_kind, rule=None):
    """The plain PyTorch twin of the CUDA kernels, on any device.

    The TPU kernel's association (``gap * (acc - v * wsum) / cnt``; the
    receptor currents summed as ``(a + b) + c``; ``m^3`` as ``m * (m * m)``
    and ``n^4`` as ``(n * n) * (n * n)``; the m and n rates' limits where
    they are 0 / 0, as the plain route takes them) and the kernels' exp
    (`core.plasticity.kernel_exp`), so the twin and the kernels agree bit
    for bit on any device.  Divisions by constants divide by 0-dim
    tensors: CUDA PyTorch turns a Python-scalar divisor into a multiply by
    its reciprocal.  Shifted reads are slices of padded planes (v, t and
    the masks pad with 0, lft with NEVER), which is what the kernels'
    bounds checks do.
    """
    rows, cols = in_deg.shape
    dev, f32 = in_deg.device, torch.float32

    def plane(k):
        return state[k].reshape(rows, cols)

    def types(k):
        return list(state[k].reshape(rows, cols, N_TYPES).unbind(-1))

    dt, c_m, v_th, gap, na_g, na_e, k_g, k_e, kl_g, kl_e = (
        plane(k) for k in PARAM_ORDER)
    ntp = {k: types(k) for k in nt_param_keys(nt_kind)}
    recp = {k: types(k) for k in rec_param_keys(rec_kind)}
    kin_keys = rec_param_keys(rec_kind)[:-3]      # the gating kinetics
    ntm = types("nt$mask")
    ntm_f = [m.to(f32) for m in ntm]
    recm = types("rec$mask")
    emask = [m.to(f32) for m in mask.unbind(0)]
    masks = list(mask.unbind(0))
    w = list(weights.unbind(0))
    cnt = torch.clamp(in_deg, min=1.0)
    c10, c18, c20, c80, c375 = (torch.tensor(x, dtype=f32, device=dev)
                                for x in (10.0, 18.0, 20.0, 80.0, 3.75))
    r = rule_tensors(rule, dev) if rule is not None else None
    v, m, h, n = (plane(k) for k in STATE_KEYS[:4])
    wasinc, spk = plane("was_increasing"), plane("is_spiking")
    lft = plane("last_firing_time")
    ntt, recr = types("nt$t"), types("rec$r")
    zeros = torch.zeros_like(v)
    for k in range(int(n_steps)):
        # 1. electrical input
        i_elec = zeros
        if electrical:
            acc, wsum = zeros, zeros
            for o, vs in enumerate(shifted(v, offsets, 0.0)):
                acc = acc + w[o] * vs
                wsum = wsum + w[o]
            i_elec = gap * (acc - v * wsum) / cnt
        # 2. chemical input, per type
        t_in, valid = [], []
        for q in range(N_TYPES):
            sums, cnts = zeros, zeros
            for o, (ts, ms) in enumerate(zip(
                    shifted(ntt[q] * ntm_f[q], offsets, 0.0),
                    shifted(ntm_f[q], offsets, 0.0))):
                sums = sums + w[o] * ts
                cnts = cnts + emask[o] * ms
            t_in.append(sums / torch.clamp(cnts, min=1.0))
            valid.append(cnts > 0.0)
        # 3. receptor kinetics and currents at the pre-update v
        for q in range(N_TYPES):
            new_r = rec_kinetics(rec_kind, recr[q], t_in[q],
                                 [recp[k][q] for k in kin_keys], dt)
            recr[q] = torch.where(valid[q] & recm[q], new_r, recr[q])
        block = 1.0 / (1.0 + kernel_exp(-0.062 * v) * recp["rec$mg"][1]
                       / c375)
        cur = [recp["rec$g"][q] * recr[q] * (v - recp["rec$e"][q])
               for q in range(N_TYPES)]
        cur[1] = cur[1] * block
        reccur = [torch.where(recm[q], cur[q], 0.0) for q in range(N_TYPES)]
        i_ligand = (reccur[0] + reccur[1] + reccur[2]) * (dt / c_m)
        # 4. gates from the old v, then the voltage
        # the m and n rates take their limits where they are 0 / 0
        # (`models.ion_channels`)
        x = v + 40.0
        m_alpha = torch.where(x == 0.0, 1.0, 0.1 * (
            x / (1.0 - kernel_exp(-x / c10))))
        m_beta = 4.0 * kernel_exp(-(v + 65.0) / c18)
        h_alpha = 0.07 * kernel_exp(-(v + 65.0) / c20)
        h_beta = 1.0 / (kernel_exp(-(v + 35.0) / c10) + 1.0)
        m = m + dt * (m_alpha * (1.0 - m) - m_beta * m)
        h = h + dt * (h_alpha * (1.0 - h) - h_beta * h)
        x = v + 55.0
        n_alpha = torch.where(x == 0.0, 0.1,
                              0.01 * x / (1.0 - kernel_exp(-x / c10)))
        n_beta = 0.125 * kernel_exp(-(v + 65.0) / c80)
        n = n + dt * (n_alpha * (1.0 - n) - n_beta * n)
        i_na = m * (m * m) * h * na_g * (v - na_e)
        i_k = (n * n) * (n * n) * k_g * (v - k_e)
        i_kl = kl_g * (v - kl_e)
        v_new = v + dt * (i_elec - (i_na + i_k + i_kl)) / c_m - i_ligand
        # 5. neurotransmitter release, from the previous step's spikes
        spk_f = spk.to(f32)
        ntt = [torch.where(ntm[q], nt_release(
            nt_kind, ntt[q], v_new, spk_f,
            [ntp[k][q] for k in nt_param_keys(nt_kind)], dt), 0.0)
            for q in range(N_TYPES)]
        # 6. peak-detection spikes
        inc = v < v_new
        spk = (v_new > v_th) & wasinc & torch.logical_not(inc)
        wasinc = inc
        lft = lft.masked_fill(spk, int(clock0) + k)
        v = v_new
        # 7. STDP from the post-step firing times and spikes
        if r is not None:
            spk_f = spk.to(f32)
            lft_pre = shifted(lft, offsets, NEVER)
            for o, sp in enumerate(shifted(spk_f, offsets, 0.0)):
                delta = stdp_delta(lft_pre[o], lft, r, kernel_exp)
                w[o] = torch.where(masks[o], w[o] + delta * (sp + spk_f),
                                   w[o])
    out = dict(state)
    fields = (v, m, h, n, wasinc, spk, lft)
    out.update((key, x.reshape(-1)) for key, x in zip(STATE_KEYS, fields))

    def stack(planes):
        return torch.stack(planes, -1).reshape(-1, N_TYPES)

    out["nt$t"], out["rec$r"], out["rec$current"] = (
        stack(ntt), stack(recr), stack(reccur))
    for key, x in zip(CURRENT_KEYS[1:], (i_na, i_k, i_kl)):
        out[key] = x.reshape(-1)
    return out, torch.stack(w) if r is not None else weights

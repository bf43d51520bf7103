"""The plain reference of both configurations: an electrical Izhikevich
lattice on a stencil graph, optionally with R-STDP under a reward, and
the closed loop of an R-STDP lattice and its environment.

Plain PyTorch on any device, written from the model's equations (the
upstream ``Lattice`` / ``RewardModulatedLattice`` step), with nothing of
the port: it takes the benchmark's inputs (the graph, a request's initial
voltages) and the configuration, and recomputes the trial.  It follows one
association of each sum (offsets in row-major order, from 0) and takes exp
as the Cephes float32 sequence (`kernel_exp`), the choices under which
float32 runs of a stencil step agree bit for bit on any device; another
association parts only where a neuron sits at its threshold.  ``dtype``
computes it in another precision (the control: bfloat16 for the float32
that the configurations state), with torch's exp there.

One step, from the state before it:

    i      = g * (sum_o w_o v[r + dr_o, c + dc_o] - v sum_o w_o) / max(deg, 1)
    dop    = dop exp(-dt / tau_d) + tau_d reward           (with a reward)
    dv     = (0.04 v^2 + 5 v + 140 - u + i) dt / c_m
    du     = a (b v - u) dt / tau_m
    v, u   = v + dv, u + du ; where v >= v_th: v = c, u += d ; lft = t
    per masked edge, twice (R-STDP):
        dw += stdp(lft_pre, lft_post)
        every second visit: c = c exp(-dt / tau_c) + tau_c dw ; dw = 0
        w  += c dop
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

NEVER = -1

# Cephes float32 exp: range reduction by ln 2 in two parts, a degree-5
# polynomial, then scaling by 2^n from the exponent bits
_LOG2E = 1.44269504088896341
_LN2_HI, _LN2_LO = 0.693359375, -2.12194440e-4
_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
         4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_EXP_MAX, _EXP_MIN = 88.72283905206835, -103.27892990343185


def kernel_exp(x):
    """exp of a float32 tensor by correctly rounded float32 operations
    only, so the same bits on every device (within about an ulp of exp)."""
    z = torch.floor(x * _LOG2E + 0.5)
    r = x - z * _LN2_HI
    r = r - z * _LN2_LO
    y = r * _POLY[0] + _POLY[1]
    for c in _POLY[2:]:
        y = y * r + c
    y = y * (r * r) + r + 1.0
    n = torch.clamp(z, -150.0, 129.0).to(torch.int32)
    half = torch.div(n, 2, rounding_mode="trunc")
    for e in (n - half, half):
        y = y * ((e + 127) << 23).view(torch.float32)
    y = torch.where(x > _EXP_MAX, float("inf"), y)
    return torch.where(x < _EXP_MIN, 0.0, y)


def _scalars(values, dtype, device):
    return {k: torch.tensor(float(v), dtype=dtype, device=device)
            for k, v in values.items()}


def _shifted(x, offsets, fill):
    """(n_off, rows, cols): out[o][r, c] = x[r + dr_o, c + dc_o], ``fill``
    off the grid."""
    rows, cols = x.shape
    pad = max(max(abs(dr), abs(dc)) for dr, dc in offsets)
    xp = F.pad(x, (pad, pad, pad, pad), value=fill)
    return torch.stack([xp[pad + dr:pad + dr + rows, pad + dc:pad + dc + cols]
                        for dr, dc in offsets])


class Trial:
    """One request's state and its step, from the configuration ``cfg``,
    the benchmark's ``graph`` (offsets, weights, mask, in_deg) and the
    request's initial voltages ``v0``."""

    def __init__(self, cfg, graph, v0, dtype=torch.float32):
        dev = v0.device
        self.dtype = dtype
        self.exp = kernel_exp if dtype == torch.float32 else torch.exp
        self.offsets = tuple(graph.offsets)
        self.p = _scalars(cfg["neuron"], dtype, dev)
        p = self.p
        self.dt_cm = p["dt"] / p["c_m"]
        self.dt_tau = p["dt"] / p["tau_m"]
        self.weights = graph.weights.to(dtype)
        self.mask = graph.mask
        self.cnt = torch.clamp(graph.in_deg.to(dtype), min=1.0)
        self.v = v0.to(dtype)
        self.u = torch.full_like(self.v, float(cfg["neuron"]["w"]))
        self.lft = torch.full(v0.shape, NEVER, dtype=torch.int32,
                              device=dev)
        self.spikes = torch.zeros(v0.shape, dtype=torch.bool, device=dev)
        self.clock = 0
        self.rstdp = cfg.get("rstdp")
        if self.rstdp is not None:
            r = dict(self.rstdp)
            # the decays taken once, in float32 on the host
            f32 = {k: torch.tensor(float(v), dtype=torch.float32)
                   for k, v in r.items()}
            r["exp_dc"] = float(torch.exp(-f32["dt"] / f32["tau_c"]))
            r["exp_dd"] = float(torch.exp(-f32["dt"] / f32["tau_d"]))
            self.r = _scalars(r, dtype, dev)
            zeros = torch.zeros_like(self.weights)
            self.c, self.dw = zeros, zeros.clone()
            self.counter = torch.zeros(self.weights.shape, dtype=torch.int32,
                                       device=dev)
            self.dop = torch.zeros((), dtype=dtype, device=dev)

    def _input(self):
        """The gap-junction current from the state before the step."""
        v, acc, wsum = self.v, torch.zeros_like(self.v), torch.zeros_like(
            self.v)
        for o, vs in enumerate(_shifted(v, self.offsets, 0.0)):
            acc = acc + self.weights[o] * vs
            wsum = wsum + self.weights[o]
        return self.p["gap_conductance"] * (acc - v * wsum) / self.cnt

    def _neurons(self, i_syn):
        p, v, u = self.p, self.v, self.u
        dv = (0.04 * v * v + 5.0 * v + 140.0 - u + i_syn) * self.dt_cm
        du = (p["a"] * (p["b"] * v - u)) * self.dt_tau
        v_pre = v + dv
        u_pre = u + du
        spk = v_pre >= p["v_th"]
        self.v = torch.where(spk, p["c"], v_pre)
        self.u = torch.where(spk, u_pre + p["d"], u_pre)
        self.lft = self.lft.masked_fill(spk, self.clock)
        self.spikes = spk

    def _stdp(self, t_pre, t_post):
        r = self.r
        both = torch.logical_and(t_pre != NEVER, t_post != NEVER)
        diff = torch.abs((t_pre - t_post).to(self.dtype)) * r["dt"]
        pre_first = t_pre < t_post
        e = self.exp(torch.where(pre_first, -diff / r["tau_plus"],
                                 -diff / r["tau_minus"]))
        dw = torch.where(pre_first, r["a_plus"] * e,
                         torch.where(t_pre > t_post, -r["a_minus"] * e, 0.0))
        return torch.where(both, dw, 0.0)

    def _visit(self, w, c, dw, counter, delta):
        r = self.r
        dw = dw + delta
        due = counter != 0
        c = torch.where(due, c * r["exp_dc"] + r["tau_c"] * dw, c)
        dw = torch.where(due, 0.0, dw)
        counter = torch.where(due, 0, 1).to(torch.int32)
        return w + c * self.dop, c, dw, counter

    def step(self, reward=None):
        """One step; ``reward`` a 0-dim tensor (R-STDP under a reward)."""
        i_syn = self._input()
        if reward is not None:
            self.dop = self.dop * self.r["exp_dd"] + self.r["tau_d"] * reward
        self._neurons(i_syn)
        if self.rstdp is not None:
            pre = _shifted(self.lft, self.offsets, NEVER)
            post = self.lft.expand_as(pre)
            delta = self._stdp(pre, post)
            state = (self.weights, self.c, self.dw, self.counter)
            out = self._visit(*self._visit(*state, delta), delta)
            self.weights, self.c, self.dw, self.counter = (
                torch.where(self.mask, new, old)
                for new, old in zip(out, state))
        self.clock += 1


def _ended(t, out=None):
    """What a trial ends on: its neurons (and synapses, with R-STDP)."""
    out = dict(out or {}, v=t.v, w=t.u, lft=t.lft)
    if t.rstdp is not None:
        out.update(weights=t.weights, c=t.c, dw=t.dw, counter=t.counter,
                   dopamine=t.dop)
    return out


# One function a traffic kind (``benchmark/traffic/kinds/<kind>.py``), named
# as the kind: a request of the mix ``traffic`` from the initial voltages
# ``v0``, as the reference computes it.

def lattice_run(cfg, traffic, graph, v0, dtype=torch.float32):
    """``steps`` steps of the lattice."""
    t = Trial(cfg, graph, v0, dtype)
    for _ in range(int(traffic["steps"])):
        t.step()
    return _ended(t)


def reward_run(cfg, traffic, graph, v0, dtype=torch.float32):
    """``steps`` R-STDP steps under the constant ``reward``."""
    t = Trial(cfg, graph, v0, dtype)
    reward = torch.tensor(float(traffic["reward"]), dtype=dtype,
                          device=v0.device)
    for _ in range(int(traffic["steps"])):
        t.step(reward)
    return _ended(t)


def closed_loop(cfg, traffic, graph, v0, dtype=torch.float32):
    """An episode of ``steps`` R-STDP steps in the environment ``env``: the
    reward from the rate before the step, the rate's update from the
    step's spikes, then the cue held; also returns the rewards and the
    rate."""
    t = Trial(cfg, graph, v0, dtype)
    env = traffic["env"]
    rate = torch.zeros((), dtype=dtype, device=v0.device)
    flat = torch.arange(v0.numel(), device=v0.device).reshape(v0.shape)
    cue = flat < int(env["cue_neurons"])
    rewards = []
    for _ in range(int(traffic["steps"])):
        reward = torch.clamp(env["target_rate"] - rate, -env["clip"],
                             env["clip"])
        rewards.append(reward)
        t.step(reward)
        rate = env["keep"] * rate + env["take"] * t.spikes.reshape(
            -1).to(dtype).mean()
        t.v = torch.where(cue, env["cue_mv"], t.v)
    return _ended(t, {"rewards": torch.stack(rewards), "rate": rate})


# The faults that ``control.py --fault`` plants in this reference while it
# computes the control in the program's place: name -> context manager.

@contextlib.contextmanager
def frozen_synapses():
    """R-STDP's visit returning the synapses unchanged: the weights, the
    traces and the visit counter stay as they were while the neurons
    step."""
    visit = Trial._visit
    Trial._visit = lambda self, w, c, dw, counter, delta: (w, c, dw, counter)
    try:
        yield
    finally:
        Trial._visit = visit


FAULTS = {"frozen_synapses": frozen_synapses}

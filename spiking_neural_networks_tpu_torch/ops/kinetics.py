"""Neurotransmitter and receptor kinetics, elementwise over (N, K) type axes.

PyTorch counterpart of ``spiking_neural_networks_tpu/ops/kinetics.py``.
State is struct-of-arrays: every kinetics parameter is an ``(N, K)`` tensor
(``N`` neurons, ``K`` static neurotransmitter types) with a boolean ``mask``
marking which (neuron, type) slots exist.  Kinetics are selected statically
(per model instance) by name, and the ``*_DEFAULTS`` tables are the same
values the JAX package uses.

Ordering (as in the reference): a neuron's ``apply_t_changes`` runs after the
voltage update but before spike handling, so ``spiking`` here is the spike
flag from the PREVIOUS step while ``v`` is the freshly updated voltage.
"""

from __future__ import annotations

import torch


def _bcast(param, t):
    """An (N, K) parameter as a tensor of t's dtype and device."""
    return torch.as_tensor(param, dtype=t.dtype, device=t.device)


def _clip(x, lo, hi):
    """``jnp.clip``: maximum with ``lo``, then minimum with ``hi``."""
    return torch.minimum(torch.clamp(x, min=lo), hi)


def nt_approximate(t, v, spiking, dt, params):
    """`ApproximateNeurotransmitter`:
    t += dt * -clearance_constant * t + is_spiking * t_max ; clamp [0, t_max]
    """
    t_max = _bcast(params["nt$t_max"], t)
    clearance = _bcast(params["nt$clearance_constant"], t)
    spike = spiking[..., None].to(t.dtype)
    new_t = t + dt[..., None] * -clearance * t + spike * t_max
    return _clip(new_t, 0.0, t_max)


def nt_discrete(t, v, spiking, dt, params):
    """`DiscreteSpikeNeurotransmitter`: t = t_max while spiking, else 0."""
    t_max = _bcast(params["nt$t_max"], t)
    return t_max * spiking[..., None].to(t.dtype)


def _exp_decay(x, l, dt):
    """`exp_decay` helper: -x * exp(dt / -l)."""
    return -x * torch.exp(dt / -l)


def nt_exponential_decay(t, v, spiking, dt, params):
    """`ExponentialDecayNeurotransmitter`."""
    t_max = _bcast(params["nt$t_max"], t)
    decay = _bcast(params["nt$decay_constant"], t)
    spike = spiking[..., None].to(t.dtype)
    new_t = t + _exp_decay(t, decay, dt[..., None]) + spike * t_max
    return _clip(new_t, 0.0, t_max)


def nt_destexhe(t, v, spiking, dt, params):
    """`DestexheNeurotransmitter`: t = t_max / (1 + exp(-(v - v_p) / k_p))."""
    t_max = _bcast(params["nt$t_max"], t)
    v_p = _bcast(params["nt$v_p"], t)
    k_p = _bcast(params["nt$k_p"], t)
    return t_max / (1.0 + torch.exp(-(v[..., None] - v_p) / k_p))


NT_KINETICS = {
    "approximate": nt_approximate,
    "discrete": nt_discrete,
    "exponential_decay": nt_exponential_decay,
    "destexhe": nt_destexhe,
    # the approximate rule with a smaller default clearance constant
    "bounded": nt_approximate,
}

# Extra per-(neuron, type) state fields each neurotransmitter kinetics needs,
# with default values.
NT_PARAM_DEFAULTS = {
    "approximate": {"nt$t_max": 1.0, "nt$clearance_constant": 0.01},
    "discrete": {"nt$t_max": 1.0},
    "exponential_decay": {"nt$t_max": 1.0, "nt$decay_constant": 2.0},
    "destexhe": {"nt$t_max": 1.0, "nt$v_p": 2.0, "nt$k_p": 5.0},
    "bounded": {"nt$t_max": 1.0, "nt$clearance_constant": 0.001},
}


def apply_t_changes(kind, state, v, spiking):
    """The updated (N, K) neurotransmitter concentrations; slots not present
    (mask False) stay at t = 0."""
    t = state["nt$t"]
    new_t = NT_KINETICS[kind](t, v, spiking, state["dt"], state)
    return torch.where(state["nt$mask"], new_t, 0.0)


# ---------------------------------------------------------------------------
# Receptor kinetics: r(r_prev, t_input, dt)
# ---------------------------------------------------------------------------


def rec_approximate(r, t, dt, params):
    """`ApproximateReceptor`: r = t."""
    return t


def rec_destexhe(r, t, dt, params):
    """`DestexheReceptor`: r += (alpha * t * (1 - r) - beta * r) * dt."""
    alpha = _bcast(params["rec$alpha"], r)
    beta = _bcast(params["rec$beta"], r)
    return r + (alpha * t * (1.0 - r) - beta * r) * dt[..., None]


def rec_exponential_decay(r, t, dt, params):
    """`ExponentialDecayReceptor`."""
    r_max = _bcast(params["rec$r_max"], r)
    decay = _bcast(params["rec$decay_constant"], r)
    new_r = r + _exp_decay(r, decay, dt[..., None]) + t
    return _clip(new_r, 0.0, r_max)


def rec_bounded(r, t, dt, params):
    """`BoundedReceptorKinetics`: r = clamp(t, 0, r_max)."""
    r_max = _bcast(params["rec$r_max"], r)
    return _clip(t, 0.0, r_max)


REC_KINETICS = {
    "approximate": rec_approximate,
    "destexhe": rec_destexhe,
    "exponential_decay": rec_exponential_decay,
    "bounded": rec_bounded,
}

REC_PARAM_DEFAULTS = {
    "approximate": {},
    "destexhe": {"rec$alpha": 1.0, "rec$beta": 1.0},
    "exponential_decay": {"rec$r_max": 1.0, "rec$decay_constant": 2.0},
    "bounded": {"rec$r_max": 1.0},
}


def update_receptor_kinetics(kind, state, t_input, t_valid):
    """Updated (N, K) receptor gating values: only types present in the
    input (``t_valid``) and inserted on the neuron (``rec$mask``) change."""
    r = state["rec$r"]
    new_r = REC_KINETICS[kind](r, t_input, state["dt"], state)
    update = torch.logical_and(t_valid, state["rec$mask"])
    return torch.where(update, new_r, r)


# ---------------------------------------------------------------------------
# The kernel routes' kinetics (the plain twins of csrc/chem_common.cuh's
# rec_kinetics and nt_release): per-type planes, every exp `kernel_exp`
# ---------------------------------------------------------------------------

# per-(neuron, type) kinetics parameters, in the kernels' order
NT_PARAM_KEYS = {"approximate": ("nt$t_max", "nt$clearance_constant"),
                 "bounded": ("nt$t_max", "nt$clearance_constant"),
                 "discrete": ("nt$t_max",),
                 "exponential_decay": ("nt$t_max", "nt$decay_constant"),
                 "destexhe": ("nt$t_max", "nt$v_p", "nt$k_p")}
REC_KIN_KEYS = {"approximate": (), "bounded": ("r_max",),
                "destexhe": ("alpha", "beta"),
                "exponential_decay": ("r_max", "decay_constant")}


def rec_kinetics(kind, r, t, p, dt):
    """A receptor slot's gating value after input ``t`` (the kernels'
    ``rec_kinetics``), ``p`` the kinetics' parameters in `REC_KIN_KEYS`
    order."""
    # imported here: core.plasticity imports models.base, which imports
    # this module
    from ..core.plasticity import kernel_exp
    if kind == "approximate":
        return t
    if kind == "bounded":
        return _clip(t, 0.0, p[0])
    if kind == "destexhe":
        return r + (p[0] * t * (1.0 - r) - p[1] * r) * dt
    return _clip(r + -r * kernel_exp(dt / -p[1]) + t, 0.0, p[0])


def nt_release(kind, t0, v, spk, p, dt):
    """A neurotransmitter slot's concentration after a step (the kernels'
    ``nt_release``) from the voltage ``v`` and the spike flag ``spk``
    (float), ``p`` the kinetics' parameters in `NT_PARAM_KEYS` order."""
    from ..core.plasticity import kernel_exp
    if kind in ("approximate", "bounded"):
        return _clip(t0 + dt * -p[1] * t0 + spk * p[0], 0.0, p[0])
    if kind == "discrete":
        return p[0] * spk
    if kind == "exponential_decay":
        return _clip(t0 + -t0 * kernel_exp(dt / -p[1]) + spk * p[0], 0.0,
                     p[0])
    return p[0] / (1.0 + kernel_exp(-(v - p[1]) / p[2]))

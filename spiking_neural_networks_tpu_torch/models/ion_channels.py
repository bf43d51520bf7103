"""Hodgkin-Huxley ion channels, elementwise over the neuron axis.

PyTorch counterpart of the Hodgkin-Huxley part of
``spiking_neural_networks_tpu/models/ion_channels.py``.  Channels are pure
functions over (N,) state tensors stored under a per-channel key prefix
(``na$m_state``, ``k$n_state``, ...), with the gating-variable Euler update
``state += dt * (alpha * (1 - state) - beta * state)``.  The Morris-Lecar
and calcium channels are not ported yet (ROADMAP queue 1, item 2).

``m ** 3`` and ``n ** 4`` are written as the products ``m * (m * m)`` and
``(n * n) * (n * n)``, the repeated squaring that JAX's integer power
computes; ``torch.pow`` would round them otherwise on the CPU.

The m and n activation rates ``a x / (1 - exp(-x / 10))`` are 0 / 0 where
``x = v + 40`` or ``v + 55`` is exactly 0; the JAX package returns NaN
there, and gap junctions spread it over the lattice.  The port takes the
rates' limits there (1.0 and 0.1) and agrees with the JAX package
everywhere else.
"""

from __future__ import annotations

import torch


def gate_update(alpha, beta, state, dt):
    """One Euler step of a gating variable."""
    return state + dt * (alpha * (1.0 - state) - beta * state)


def gate_init_state(alpha, beta):
    """The steady state ``alpha / (alpha + beta)`` of a gating variable."""
    return alpha / (alpha + beta)


NA_DEFAULTS = {"na$g": 120.0, "na$e": 50.0, "na$m_state": 0.0,
               "na$h_state": 0.0, "na$current": 0.0}
K_DEFAULTS = {"k$g": 36.0, "k$e": -77.0, "k$n_state": 0.0, "k$current": 0.0}
KLEAK_DEFAULTS = {"kleak$g": 0.3, "kleak$e": -55.0, "kleak$current": 0.0}


def na_channel_update(s, v, dt):
    """The sodium channel: m and h gates from v, then
    ``m^3 h g (v - e)``."""
    x = v + 40.0
    m_alpha = torch.where(x == 0.0, 1.0,
                          0.1 * (x / (1.0 - torch.exp(-x / 10.0))))
    m_beta = 4.0 * torch.exp(-(v + 65.0) / 18.0)
    h_alpha = 0.07 * torch.exp(-(v + 65.0) / 20.0)
    h_beta = 1.0 / (torch.exp(-(v + 35.0) / 10.0) + 1.0)
    m = gate_update(m_alpha, m_beta, s["na$m_state"], dt)
    h = gate_update(h_alpha, h_beta, s["na$h_state"], dt)
    current = m * (m * m) * h * s["na$g"] * (v - s["na$e"])
    return {"na$m_state": m, "na$h_state": h, "na$current": current}


def k_channel_update(s, v, dt):
    """The potassium channel: the n gate from v, then ``n^4 g (v - e)``."""
    x = v + 55.0
    n_alpha = torch.where(x == 0.0, 0.1,
                          0.01 * x / (1.0 - torch.exp(-x / 10.0)))
    n_beta = 0.125 * torch.exp(-(v + 65.0) / 80.0)
    n = gate_update(n_alpha, n_beta, s["k$n_state"], dt)
    current = (n * n) * (n * n) * s["k$g"] * (v - s["k$e"])
    return {"k$n_state": n, "k$current": current}


def k_leak_channel_update(s, v):
    """The potassium leak ``g (v - e)``, independent of the time step."""
    return {"kleak$current": s["kleak$g"] * (v - s["kleak$e"])}

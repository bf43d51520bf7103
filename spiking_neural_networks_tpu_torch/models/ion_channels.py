"""Ion channels, elementwise over the neuron axis.

PyTorch counterpart of ``spiking_neural_networks_tpu/models/
ion_channels.py``: the Hodgkin-Huxley, Morris-Lecar and high-voltage
calcium channels.  Channels are pure functions over (N,) state tensors
stored under a per-channel key prefix (``na$m_state``, ``kss$n``, ...),
with the gating-variable Euler update
``state += dt * (alpha * (1 - state) - beta * state)``.  The Morris-Lecar
channels take their ``tanh`` and ``cosh`` as arguments, so that a kernel
twin can pass the CUDA kernels' float-op forms.

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


# -- Morris-Lecar channels -----------------------------------------------------

CA_REDUCED_DEFAULTS = {"ca$g": 4.0, "ca$v": 120.0, "ca$m_ss": 0.0,
                       "ca$v_1": -1.2, "ca$v_2": 18.0, "ca$current": 0.0}
K_SS_DEFAULTS = {"kss$g": 8.0, "kss$v": -84.0, "kss$n": 0.0, "kss$n_ss": 0.0,
                 "kss$t_n": 0.0, "kss$phi": 0.067, "kss$v_3": 12.0,
                 "kss$v_4": 17.4, "kss$current": 0.0}
LEAK_DEFAULTS = {"leak$g": 2.0, "leak$v": -60.0, "leak$current": 0.0}


def reduced_calcium_update(s, v, tanh=torch.tanh):
    """The reduced calcium channel: ``m_ss = (1 + tanh((v - v_1) / v_2))
    / 2`` from v, then ``g m_ss (v - v_ca)``."""
    m_ss = 0.5 * (1.0 + tanh((v - s["ca$v_1"]) / s["ca$v_2"]))
    current = s["ca$g"] * m_ss * (v - s["ca$v"])
    return {"ca$m_ss": m_ss, "ca$current": current}


def k_steady_state_update(s, v, dt, tanh=torch.tanh, cosh=torch.cosh):
    """The steady-state potassium channel: n relaxes to ``n_ss`` with the
    time constant ``t_n = 1 / (phi cosh((v - v_3) / (2 v_4)))``, then
    ``g n (v - v_k)``."""
    n_ss = 0.5 * (1.0 + tanh((v - s["kss$v_3"]) / s["kss$v_4"]))
    t_n = 1.0 / (s["kss$phi"]
                 * cosh((v - s["kss$v_3"]) / (2.0 * s["kss$v_4"])))
    n = s["kss$n"] + ((n_ss - s["kss$n"]) / t_n) * dt
    current = s["kss$g"] * n * (v - s["kss$v"])
    return {"kss$n_ss": n_ss, "kss$t_n": t_n, "kss$n": n,
            "kss$current": current}


def leak_channel_update(s, v):
    """The leak ``g (v - v_leak)``, independent of the time step."""
    return {"leak$current": s["leak$g"] * (v - s["leak$v"])}


# -- Additional library channels -------------------------------------------------

CA_DEFAULTS = {"hva_ca$g": 0.025, "hva_ca$e": 80.0, "hva_ca$s_state": 0.0,
               "hva_ca$current": 0.0}


def calcium_channel_update(s, v, dt, exp=torch.exp):
    """The high-voltage activated calcium channel: the s gate from v, then
    ``-s^2 g (v - e)``.  ``1.6 / x`` and ``/ 5`` divide by tensors, as the
    JAX package divides (torch's ``scalar / x`` is ``reciprocal(x) *
    scalar``, and a CUDA tensor divided by a Python scalar is multiplied
    by its reciprocal)."""
    s_alpha = torch.div(v.new_tensor(1.6),
                        1.0 + exp(-0.072 * (v - 5.0)))
    s_beta = (0.02 * (v + 8.9)) / (exp(v + 8.9) / v.new_tensor(5.0) - 1.0)
    gate = gate_update(s_alpha, s_beta, s["hva_ca$s_state"], dt)
    current = -(gate * gate) * s["hva_ca$g"] * (v - s["hva_ca$e"])
    return {"hva_ca$s_state": gate, "hva_ca$current": current}

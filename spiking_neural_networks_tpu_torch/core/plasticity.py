"""Plasticity rules: the STDP parameter holder.

PyTorch counterpart of ``spiking_neural_networks_tpu/core/plasticity.py``.
Only the parameters are ported so far; the weight updates are ROADMAP
queue 1, item 3, and a lattice with ``do_plasticity=True`` raises
``NotImplementedError`` until then.
"""

from __future__ import annotations

PLASTICITY_NOT_PORTED = (
    "plasticity is not ported to the PyTorch package yet "
    "(ROADMAP queue 1, item 3)")


class STDP:
    """Pair-based spike-time-dependent plasticity parameters.

    t_pre < t_post:  dw = +a_plus  * exp(-|t_pre - t_post| * dt / tau_plus)
    t_pre > t_post:  dw = -a_minus * exp(-|t_post - t_pre| * dt / tau_minus)
    """

    name = "stdp"

    def __init__(self, a_plus=2.0, a_minus=2.0, tau_plus=4.5, tau_minus=4.5,
                 dt=0.1):
        self.params = dict(a_plus=a_plus, a_minus=a_minus, tau_plus=tau_plus,
                           tau_minus=tau_minus, dt=dt)

    def set_dt(self, dt):
        self.params["dt"] = dt

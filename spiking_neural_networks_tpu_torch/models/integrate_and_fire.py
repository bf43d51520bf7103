"""Integrate-and-fire models: the Izhikevich model.

PyTorch counterpart of ``spiking_neural_networks_tpu/models/
integrate_and_fire.py``.  The other seven models of that file are not
ported yet.
"""

from __future__ import annotations

from .base import NeuronModel


class Izhikevich(NeuronModel):
    """Izhikevich neuron.

    dv = (0.04 v^2 + 5 v + 140 - w + i) * (dt / c_m)
    dw = (a (b v - w)) * (dt / tau_m) ; spike: v -> c, w += d

    The parenthesised associations are the JAX package's, so the two agree
    to the last bit where the backends round alike.
    """

    name = "izhikevich"
    FIELDS = dict(
        v=-65.0, v_th=30.0, v_init=-65.0, a=0.02, b=0.2, c=-55.0, d=8.0,
        w=30.0, w_init=30.0, gap_conductance=7.0, tau_m=1.0, c_m=100.0, dt=0.1,
    )

    def deltas(self, s, i):
        dv = (0.04 * s["v"] * s["v"] + 5.0 * s["v"] + 140.0 - s["w"] + i) \
            * (s["dt"] / s["c_m"])
        dw = (s["a"] * (s["b"] * s["v"] - s["w"])) * (s["dt"] / s["tau_m"])
        return {"v": dv, "w": dw}

    def handle_spiking(self, s):
        return self._handle_izhikevich(s)

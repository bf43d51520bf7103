"""Integrate-and-fire models: leaky, adaptive leaky and Izhikevich.

PyTorch counterpart of ``spiking_neural_networks_tpu/models/
integrate_and_fire.py``.  The other five models of that file are not
ported yet.  The parenthesised associations are the JAX package's, so the
two agree to the last bit where the backends round alike.
"""

from __future__ import annotations

from .base import NeuronModel


class LeakyIntegrateAndFire(NeuronModel):
    """Leaky integrate-and-fire neuron with a refractory period.

    dv = (leak_constant (v - e_l) + integration_constant (i / g_l))
         * (dt / tau_m)
    """

    name = "leaky_integrate_and_fire"
    FIELDS = dict(
        v=-75.0, v_th=-55.0, v_reset=-75.0, v_init=-75.0,
        refractory_count=0.0, tref=10.0, leak_constant=-1.0,
        integration_constant=1.0, gap_conductance=7.0, e_l=-75.0,
        g_l=10.0, tau_m=10.0, c_m=100.0, dt=0.1,
    )

    def deltas(self, s, i):
        dv = ((s["leak_constant"] * (s["v"] - s["e_l"]))
              + (s["integration_constant"] * (i / s["g_l"]))) \
            * (s["dt"] / s["tau_m"])
        return {"v": dv}

    def handle_spiking(self, s):
        return self._handle_refractory_reset(s)


class AdaptiveLeakyIntegrateAndFire(NeuronModel):
    """Adaptive leaky integrate-and-fire neuron.

    dv = (leak_constant (v - e_l) + integration_constant (i / g_l)
          - w / g_l) * (dt / c_m)
    dw = (alpha (v - e_l) - w) * (dt / tau_m) ; spike: w += beta
    """

    name = "adaptive_leaky_integrate_and_fire"
    FIELDS = dict(
        v=-75.0, v_th=-55.0, v_reset=-75.0, v_init=-75.0,
        refractory_count=0.0, tref=10.0, alpha=6.0, beta=10.0,
        w=0.0, w_init=0.0, leak_constant=-1.0, integration_constant=1.0,
        gap_conductance=7.0, e_l=-75.0, g_l=10.0, tau_m=10.0, c_m=100.0,
        dt=0.1,
    )

    def deltas(self, s, i):
        dv = ((s["leak_constant"] * (s["v"] - s["e_l"]))
              + (s["integration_constant"] * (i / s["g_l"]))
              - (s["w"] / s["g_l"])) * (s["dt"] / s["c_m"])
        dw = (s["alpha"] * (s["v"] - s["e_l"]) - s["w"]) \
            * (s["dt"] / s["tau_m"])
        return {"v": dv, "w": dw}

    def handle_spiking(self, s):
        return self._handle_adaptive(s)


class Izhikevich(NeuronModel):
    """Izhikevich neuron.

    dv = (0.04 v^2 + 5 v + 140 - w + i) * (dt / c_m)
    dw = (a (b v - w)) * (dt / tau_m) ; spike: v -> c, w += d
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

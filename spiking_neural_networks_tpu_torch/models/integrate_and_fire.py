"""The integrate-and-fire model family.

PyTorch counterpart of ``spiking_neural_networks_tpu/models/
integrate_and_fire.py``: the leaky, quadratic, adaptive leaky, adaptive
exponential, Izhikevich, leaky Izhikevich, BCM Izhikevich and simple leaky
neurons.  The parenthesised associations are the JAX package's, so the two
agree to the last bit where the backends round alike.
"""

from __future__ import annotations

import torch

from .base import TORCH_FNS, NeuronModel


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

    def deltas(self, s, i, fns=TORCH_FNS):
        dv = ((s["leak_constant"] * (s["v"] - s["e_l"]))
              + (s["integration_constant"] * (i / s["g_l"]))) \
            * (s["dt"] / s["tau_m"])
        return {"v": dv}

    def handle_spiking(self, s):
        return self._handle_refractory_reset(s)


class QuadraticIntegrateAndFire(NeuronModel):
    """Quadratic integrate-and-fire neuron with a refractory period.

    dv = (alpha (v - v_reset) (v - v_c) + integration_constant i)
         * (dt / tau_m)
    """

    name = "quadratic_integrate_and_fire"
    FIELDS = dict(
        v=-75.0, v_th=-55.0, v_reset=-75.0, v_init=-75.0,
        refractory_count=0.0, tref=10.0, alpha=1.0, v_c=-60.0,
        integration_constant=1.0, gap_conductance=7.0,
        tau_m=100.0, c_m=100.0, dt=0.1,
    )

    def deltas(self, s, i, fns=TORCH_FNS):
        dv = ((s["alpha"] * (s["v"] - s["v_reset"]) * (s["v"] - s["v_c"]))
              + s["integration_constant"] * i) * (s["dt"] / s["tau_m"])
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

    def deltas(self, s, i, fns=TORCH_FNS):
        dv = ((s["leak_constant"] * (s["v"] - s["e_l"]))
              + (s["integration_constant"] * (i / s["g_l"]))
              - (s["w"] / s["g_l"])) * (s["dt"] / s["c_m"])
        dw = (s["alpha"] * (s["v"] - s["e_l"]) - s["w"]) \
            * (s["dt"] / s["tau_m"])
        return {"v": dv, "w": dw}

    def handle_spiking(self, s):
        return self._handle_adaptive(s)


class AdaptiveExpLeakyIntegrateAndFire(NeuronModel):
    """Adaptive exponential leaky integrate-and-fire neuron.

    dv = (leak_constant (v - e_l)
          + slope_factor exp((v - v_th) / slope_factor)
          + integration_constant (i / g_l) - w / g_l) * (dt / c_m)
    dw = (alpha (v - e_l) - w) * (dt / tau_m) ; spike: w += beta
    """

    name = "adaptive_exp_leaky_integrate_and_fire"
    FIELDS = dict(
        v=-75.0, v_th=-55.0, v_reset=-75.0, v_init=-75.0,
        refractory_count=0.0, tref=10.0, alpha=6.0, beta=10.0,
        slope_factor=1.0, w=0.0, w_init=0.0, leak_constant=-1.0,
        integration_constant=1.0, gap_conductance=7.0, e_l=-75.0,
        g_l=10.0, tau_m=10.0, c_m=100.0, dt=0.1,
    )

    def deltas(self, s, i, fns=TORCH_FNS):
        dv = ((s["leak_constant"] * (s["v"] - s["e_l"]))
              + (s["slope_factor"]
                 * fns.exp((s["v"] - s["v_th"]) / s["slope_factor"]))
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

    def deltas(self, s, i, fns=TORCH_FNS):
        dv = (0.04 * s["v"] * s["v"] + 5.0 * s["v"] + 140.0 - s["w"] + i) \
            * (s["dt"] / s["c_m"])
        dw = (s["a"] * (s["b"] * s["v"] - s["w"])) * (s["dt"] / s["tau_m"])
        return {"v": dv, "w": dw}

    def handle_spiking(self, s):
        return self._handle_izhikevich(s)


class LeakyIzhikevich(NeuronModel):
    """Izhikevich neuron with a leak through w.

    dv = (0.04 v^2 + 5 v + 140 - w (v - e_l) + i) * (dt / c_m)
    dw = (a (b v - w)) * (dt / tau_m) ; spike: v -> c, w += d
    """

    name = "leaky_izhikevich"
    FIELDS = dict(
        v=-65.0, v_th=30.0, v_init=-65.0, a=0.02, b=0.2, c=-55.0, d=8.0,
        w=30.0, w_init=30.0, e_l=-65.0, gap_conductance=7.0,
        tau_m=10.0, c_m=100.0, dt=0.1,
    )

    def deltas(self, s, i, fns=TORCH_FNS):
        dv = (0.04 * s["v"] * s["v"] + 5.0 * s["v"] + 140.0
              - s["w"] * (s["v"] - s["e_l"]) + i) * (s["dt"] / s["c_m"])
        dw = (s["a"] * (s["b"] * s["v"] - s["w"])) * (s["dt"] / s["tau_m"])
        return {"v": dv, "w": dw}

    def handle_spiking(self, s):
        return self._handle_izhikevich(s)


class BCMIzhikevich(NeuronModel):
    """Izhikevich dynamics with the sliding firing-rate bookkeeping of the
    BCM rule.  As the reference: ``num_spikes`` never resets, and the
    activity is normalised by ``window * dt`` on the electrical path and
    by ``window`` on the chemical one (``chemical_normalization``).
    """

    name = "bcm_izhikevich"
    FIELDS = dict(
        v=-65.0, v_th=30.0, v_init=-65.0, a=0.02, b=0.2, c=-55.0, d=8.0,
        w=30.0, w_init=30.0, gap_conductance=7.0, tau_m=1.0, c_m=100.0, dt=0.1,
        average_activity=0.0, current_activity=0.0, firing_rate_clock=0.0,
        firing_rate_window=500.0, period=3.0,
    )
    INT_FIELDS = dict(num_spikes=0)

    def __init__(self, chemical_normalization=False, **kw):
        super().__init__(**kw)
        self.chemical_normalization = chemical_normalization

    def config_key(self):
        return super().config_key() + (self.chemical_normalization,)

    def pre_update(self, s):
        s = dict(s)
        s["num_spikes"] = s["num_spikes"] + s["is_spiking"].to(torch.int32)
        clock = s["firing_rate_clock"] + s["dt"]
        window_hit = clock >= s["firing_rate_window"]
        # window * 1.0 is the window exactly
        denom = s["firing_rate_window"] if self.chemical_normalization \
            else s["firing_rate_window"] * s["dt"]
        activity = s["num_spikes"].to(torch.float32) / denom
        s["firing_rate_clock"] = torch.where(window_hit, 0.0, clock)
        s["current_activity"] = torch.where(window_hit, activity,
                                            s["current_activity"])
        avg = s["average_activity"]
        avg_new = avg - avg / s["period"] + activity / s["period"]
        s["average_activity"] = torch.where(window_hit, avg_new, avg)
        return s

    def deltas(self, s, i, fns=TORCH_FNS):
        dv = (0.04 * s["v"] * s["v"] + 5.0 * s["v"] + 140.0 - s["w"] + i) \
            * (s["dt"] / s["c_m"])
        dw = (s["a"] * (s["b"] * s["v"] - s["w"])) * (s["dt"] / s["tau_m"])
        return {"v": dv, "w": dw}

    def handle_spiking(self, s):
        return self._handle_izhikevich(s)


class SimpleLeakyIntegrateAndFire(NeuronModel):
    """Simple leaky integrate-and-fire neuron, no refractory period.

    dv = (g (v - e) + i) * dt ; spike: v -> v_reset
    """

    name = "simple_leaky_integrate_and_fire"
    FIELDS = dict(
        v=-75.0, g=-0.1, e=0.0, v_th=-55.0, v_reset=-75.0, v_init=-75.0,
        gap_conductance=10.0, c_m=100.0, dt=0.1,
    )

    def deltas(self, s, i, fns=TORCH_FNS):
        return {"v": (s["g"] * (s["v"] - s["e"]) + i) * s["dt"]}

    def handle_spiking(self, s):
        return self._handle_simple_reset(s)

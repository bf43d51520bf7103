"""The Morris-Lecar reduced conductance model.

PyTorch counterpart of ``spiking_neural_networks_tpu/models/
morris_lecar.py``.
"""

from __future__ import annotations

from .base import TORCH_FNS, NeuronModel
from ..ops import kinetics as K
from . import ion_channels as ch


class MorrisLecar(NeuronModel):
    """Morris-Lecar neuron: reduced calcium, steady-state potassium and
    leak channels, peak-detection spikes.

    Step order: [receptors] -> channel updates from the old v ->
    ``v += (i - i_leak - i_ca - i_k) * (dt / c_m) - receptor dv`` ->
    neurotransmitter release -> peak-detection spike.  The default
    kinetics are Destexhe's.
    """

    name = "morris_lecar"
    FIELDS = dict(
        v=-70.0, v_init=-70.0, v_th=25.0, gap_conductance=10.0,
        c_m=6.6, dt=0.01,
        **ch.CA_REDUCED_DEFAULTS, **ch.K_SS_DEFAULTS, **ch.LEAK_DEFAULTS,
    )
    BOOL_FIELDS = dict(was_increasing=False)

    def __init__(self, nt_kinetics="destexhe", rec_kinetics="destexhe",
                 receptors=None):
        super().__init__(nt_kinetics=nt_kinetics, rec_kinetics=rec_kinetics,
                         receptors=receptors)

    def step(self, s, i, t_input=None, t_valid=None, skip_nt=False,
             fns=TORCH_FNS):
        s = dict(s)
        if t_input is not None:
            s.update(self.receptors.update_kinetics(s, t_input, t_valid))
            s.update(self.receptors.set_currents(s, s["v"]))
            rec_dv = self.receptors.receptor_dv(s)
        else:
            rec_dv = 0.0

        s.update(ch.reduced_calcium_update(s, s["v"], fns.tanh))
        s.update(ch.k_steady_state_update(s, s["v"], s["dt"], fns.tanh,
                                          fns.cosh))
        s.update(ch.leak_channel_update(s, s["v"]))

        last_voltage = s["v"]
        dv = (i - s["leak$current"] - s["ca$current"] - s["kss$current"]) \
            * (s["dt"] / s["c_m"])
        s["v"] = s["v"] + dv - rec_dv

        if not skip_nt:
            s["nt$t"] = K.apply_t_changes(
                self.nt_kinetics, s, s["v"], s["is_spiking"])

        s, spikes = self._handle_peak_detection(s, last_voltage)
        s["is_spiking"] = spikes
        return s, spikes

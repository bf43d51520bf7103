"""Izhikevich with DopaGluGABA receptors.

PyTorch counterpart of ``spiking_neural_networks_tpu/models/dopa.py``: the
Izhikevich neuron of the lixirnet pipelines, with bounded neurotransmitter
and receptor kinetics and the `DopaGluGABAReceptors` set by default.
"""

from __future__ import annotations

from .base import TORCH_FNS, NeuronModel
from ..ops.receptors import DopaGluGABAReceptors


class DopaIzhikevich(NeuronModel):
    """Izhikevich neuron with its own defaults (c -55, d 8, v_th 30,
    c_m 100, w 30, gap conductance 10).

        dw = (a (b v - w)) * (dt / tau_m)
        dv = (0.04 v^2 + 5 v + 140 - w + i) * (dt / c_m)
        spike: v >= v_th -> v = c, w += d
    """

    name = "dopa_izhikevich"
    FIELDS = dict(
        v=-65.0, w=30.0, a=0.02, b=0.2, c=-55.0, d=8.0, v_th=30.0,
        tau_m=1.0, c_m=100.0, gap_conductance=10.0, dt=0.1,
    )

    def __init__(self, nt_kinetics="bounded", rec_kinetics="bounded",
                 receptors=None):
        if receptors is None:
            receptors = DopaGluGABAReceptors(rec_kinetics)
        super().__init__(nt_kinetics=nt_kinetics, rec_kinetics=rec_kinetics,
                         receptors=receptors)

    def deltas(self, s, i, fns=TORCH_FNS):
        dw = (s["a"] * (s["b"] * s["v"] - s["w"])) * (s["dt"] / s["tau_m"])
        dv = (0.04 * s["v"] * s["v"] + 5.0 * s["v"] + 140.0 - s["w"] + i) \
            * (s["dt"] / s["c_m"])
        return {"v": dv, "w": dw}

    def handle_spiking(self, s):
        return self._handle_izhikevich(s)

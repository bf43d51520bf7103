"""Receptor (ligand-gated channel) systems, elementwise over (N, K).

PyTorch counterpart of ``spiking_neural_networks_tpu/ops/receptors.py``:
:class:`ReceptorSystem`, :class:`IonotropicReceptors` (AMPA/NMDA/GABA) and
:class:`DopaGluGABAReceptors` (Glutamate/GABA/Dopamine with D1/D2 gain
modulation).  A receptor system is a static config object; per-neuron
values live in the state dict under ``rec$``-prefixed keys, with a boolean
(N, K) mask for inserted receptors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kinetics as K

# Static neurotransmitter-type axis for the Ionotropic receptor set.
AMPA, NMDA, GABA = 0, 1, 2
IONOTROPIC_TYPES = ("AMPA", "NMDA", "GABA")
N_IONOTROPIC = 3

DEFAULT_G = (1.0, 0.6, 1.2)
DEFAULT_E = (0.0, 0.0, -80.0)
DEFAULT_MG = 0.3


def set_col(arr, k, v):
    """A copy of ``arr`` with ``arr[:, k] = v``."""
    out = arr.clone()
    out[:, k] = torch.as_tensor(v, dtype=arr.dtype, device=arr.device)
    return out


class ReceptorSystem:
    """Static receptor-set configuration.  Subclasses define the type axis,
    the per-neuron state fields, gating-kinetics updates, and currents."""

    type_names: tuple = ()

    @property
    def n_types(self):
        return len(self.type_names)

    def config_key(self):
        return (type(self),)

    def __hash__(self):
        return hash(self.config_key())

    def __eq__(self, other):
        return isinstance(other, ReceptorSystem) \
            and self.config_key() == other.config_key()

    def init_fields(self, n):
        raise NotImplementedError

    def insert(self, state, type_name, **params):
        """`Receptors::insert`: mark the (neuron, type) slots as present and
        optionally override per-receptor params."""
        k = self.type_names.index(type_name)
        state = dict(state)
        state["rec$mask"] = set_col(state["rec$mask"], k, True)
        for p, v in params.items():
            key = f"rec${p}"
            arr = state[key]
            if arr.ndim == 2:
                state[key] = set_col(arr, k, v)
            else:
                state[key] = torch.full_like(arr, v)
        return state

    def update_kinetics(self, state, t_input, t_valid):
        raise NotImplementedError

    def set_currents(self, state, v):
        raise NotImplementedError

    def receptor_dv(self, state):
        """Total receptor current scaled by dt / c_m (applied as
        ``v += dv - receptor_dv``)."""
        raise NotImplementedError


class IonotropicReceptors(ReceptorSystem):
    """AMPA / NMDA / GABA ligand-gated channels.

      AMPA / GABA : I = g * r * (v - e)
      NMDA        : I = B(v) * g * r * (v - e),
                    B(v) = 1 / (1 + exp(-0.062 v) * mg / 3.75)
    """

    type_names = IONOTROPIC_TYPES

    def __init__(self, kinetics="approximate"):
        if kinetics not in K.REC_KINETICS:
            raise ValueError(f"unknown receptor kinetics {kinetics!r}")
        self.kinetics = kinetics

    def config_key(self):
        return (type(self), self.kinetics)

    def init_fields(self, n):
        """Host NumPy fields; the model moves the whole state to the device
        once."""
        nk = (n, self.n_types)
        s = {
            "rec$r": np.zeros(nk, np.float32),
            "rec$current": np.zeros(nk, np.float32),
            "rec$g": np.broadcast_to(np.asarray(DEFAULT_G, np.float32), nk).copy(),
            "rec$e": np.broadcast_to(np.asarray(DEFAULT_E, np.float32), nk).copy(),
            "rec$mg": np.full(nk, DEFAULT_MG, np.float32),
            "rec$mask": np.zeros(nk, bool),
        }
        for f, d in K.REC_PARAM_DEFAULTS[self.kinetics].items():
            s[f] = np.full(nk, d, np.float32)
        return s

    def update_kinetics(self, state, t_input, t_valid):
        return {"rec$r": K.update_receptor_kinetics(
            self.kinetics, state, t_input, t_valid)}

    def set_currents(self, state, v):
        """Receptor currents from the pre-update voltage."""
        r = state["rec$r"]
        g = state["rec$g"]
        e = state["rec$e"]
        mg = state["rec$mg"]
        base = g * r * (v[..., None] - e)
        nmda_block = 1.0 / (1.0 + torch.exp(-0.062 * v) * mg[..., NMDA] / 3.75)
        block = torch.ones_like(base)
        block[..., NMDA] = nmda_block
        currents = base * block
        return {"rec$current": torch.where(state["rec$mask"], currents, 0.0)}

    def receptor_dv(self, state):
        total = torch.sum(state["rec$current"], dim=-1)
        return total * (state["dt"] / state["c_m"])


class DopaGluGABAReceptors(ReceptorSystem):
    """Glutamate / GABA / Dopamine receptors with dopamine gain modulation.

      glu  = inh_mod * g_ampa * ampa_r * (v - e_ampa)
             + B(v) * inh_mod * g_nmda * nmda_r ** nmda_mod * (v - e_nmda),
             B(v) = 1 / (1 + exp(-0.062 v) * mg / 3.57)
      gaba = g_gaba * gaba_r * (v - e_gaba)
      then, where a dopamine receptor is inserted, for the next step:
      inh_mod = 1 - r_d2 * s_d2,  nmda_mod = 1 - r_d1 * s_d1

    The type axis holds [ampa_r | gaba_r | r_d1] in ``rec$r`` and
    [nmda_r | - | r_d2] in ``rec$r2``; both follow the same receptor
    kinetics, the second slot with its own ``rec$r2$<param>`` fields.  The
    current and modulation parameters are per-neuron (N,) planes.
    """

    type_names = ("Glutamate", "GABA", "Dopamine")
    GLU, GABA_T, DOPA = 0, 1, 2

    def __init__(self, kinetics="bounded"):
        if kinetics not in K.REC_KINETICS:
            raise ValueError(f"unknown receptor kinetics {kinetics!r}")
        self.kinetics = kinetics

    def config_key(self):
        return (type(self), self.kinetics)

    def init_fields(self, n):
        """Host NumPy fields; the model moves the whole state to the device
        once."""
        nk = (n, self.n_types)
        s = {
            "rec$r": np.zeros(nk, np.float32),
            "rec$r2": np.zeros(nk, np.float32),
            "rec$mask": np.zeros(nk, bool),
            "rec$current": np.zeros(nk, np.float32),
            "rec$inh_modifier": np.ones((n,), np.float32),
            "rec$nmda_modifier": np.ones((n,), np.float32),
            "rec$g_ampa": np.full((n,), 1.0, np.float32),
            "rec$g_nmda": np.full((n,), 0.6, np.float32),
            "rec$e_ampa": np.zeros((n,), np.float32),
            "rec$e_nmda": np.zeros((n,), np.float32),
            "rec$mg": np.full((n,), 0.3, np.float32),
            "rec$g_gaba": np.full((n,), 1.2, np.float32),
            "rec$e_gaba": np.full((n,), -80.0, np.float32),
            "rec$s_d1": np.zeros((n,), np.float32),
            "rec$s_d2": np.zeros((n,), np.float32),
        }
        for f, d in K.REC_PARAM_DEFAULTS[self.kinetics].items():
            s[f] = np.full(nk, d, np.float32)
            s[f.replace("rec$", "rec$r2$", 1)] = np.full(nk, d, np.float32)
        return s

    def update_kinetics(self, state, t_input, t_valid):
        r = K.update_receptor_kinetics(self.kinetics, state, t_input, t_valid)
        s2 = dict(state)
        s2["rec$r"] = state["rec$r2"]
        for f in K.REC_PARAM_DEFAULTS[self.kinetics]:
            s2[f] = state[f.replace("rec$", "rec$r2$", 1)]
        r2 = K.update_receptor_kinetics(self.kinetics, s2, t_input, t_valid)
        return {"rec$r": r, "rec$r2": r2}

    def set_currents(self, state, v):
        """Currents from the pre-update voltage and the previous step's
        modifiers, which the dopamine slot then rewrites."""
        mask = state["rec$mask"]
        inh = state["rec$inh_modifier"]
        nmda_mod = state["rec$nmda_modifier"]
        ampa_r = state["rec$r"][..., self.GLU]
        nmda_r = state["rec$r2"][..., self.GLU]
        block = 1.0 / (1.0 + torch.exp(-0.062 * v) * state["rec$mg"] / 3.57)
        glu = inh * state["rec$g_ampa"] * ampa_r * (v - state["rec$e_ampa"]) \
            + block * inh * state["rec$g_nmda"] * (nmda_r ** nmda_mod) \
            * (v - state["rec$e_nmda"])
        glu = torch.where(mask[..., self.GLU], glu, 0.0)
        gaba = state["rec$g_gaba"] * state["rec$r"][..., self.GABA_T] \
            * (v - state["rec$e_gaba"])
        gaba = torch.where(mask[..., self.GABA_T], gaba, 0.0)
        dopa = mask[..., self.DOPA]
        new_inh = torch.where(
            dopa, 1.0 - state["rec$r2"][..., self.DOPA] * state["rec$s_d2"],
            inh)
        new_nmda = torch.where(
            dopa, 1.0 - state["rec$r"][..., self.DOPA] * state["rec$s_d1"],
            nmda_mod)
        current = torch.stack([glu, gaba, torch.zeros_like(glu)], dim=-1)
        return {"rec$current": current, "rec$inh_modifier": new_inh,
                "rec$nmda_modifier": new_nmda}

    def receptor_dv(self, state):
        total = torch.sum(state["rec$current"], dim=-1)
        return total * (state["dt"] / state["c_m"])

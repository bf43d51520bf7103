"""Neuron model base: struct-of-arrays state + elementwise step functions.

PyTorch counterpart of ``spiking_neural_networks_tpu/models/base.py``.  A
model instance holds only static configuration (kinetics choices, spike
handling); every per-neuron value, parameters included, lives in a flat
``dict[str, torch.Tensor]`` state with one leading neuron axis N, keyed and
typed as in the JAX package: floats are f32, ``last_firing_time`` is int32
with ``NEVER = -1``, ``is_spiking`` and the masks are bool.

``step(state, i[, t_input, t_valid])`` is a plain function of tensors
returning ``(state, spikes)``; it allocates new tensors and never writes
into the state it was given.  Its transcendental functions come from
``fns`` (`TORCH_FNS` by default): the kernel twins pass the float-op forms
that the CUDA kernels compute (`ops.model_kernels.KERNEL_FNS`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops import kinetics as K
from ..ops import receptors as R

# Sentinel for "has not fired yet".
NEVER = -1


class Fns(NamedTuple):
    """The transcendental functions a model step takes (``log``, ``pow``,
    ``sinh``, ``log10``, ``sqrt``, ``sin``, ``cos`` and ``tan``: those of
    the DSL's generated models)."""
    exp: Callable
    tanh: Callable
    cosh: Callable
    log: Callable = torch.log
    pow: Callable = torch.pow
    sinh: Callable = torch.sinh
    log10: Callable = torch.log10
    sqrt: Callable = torch.sqrt
    sin: Callable = torch.sin
    cos: Callable = torch.cos
    tan: Callable = torch.tan


TORCH_FNS = Fns(torch.exp, torch.tanh, torch.cosh)


class NeuronModel:
    """Base class for spiking neuron models.

    Subclasses define ``FIELDS`` (per-neuron f32 fields -> default),
    optional ``INT_FIELDS`` / ``BOOL_FIELDS``, ``deltas(state, i)`` (Euler
    deltas from the old state, at least ``{'v': dv}``) and
    ``handle_spiking(state)`` returning ``(state, spikes)``.
    """

    name = "base"
    FIELDS: dict = {}
    BOOL_FIELDS: dict = {}
    INT_FIELDS: dict = {}
    # ``step(s, i, skip_nt=True)`` is elementwise over the neurons, so it
    # runs on (rows, cols) planes as well as on (N,) vectors
    # (`ops.model_kernels`).  A subclass whose step depends on the flat
    # (N,) layout sets this False.
    ELEMENTWISE_STEP = True

    def __init__(self, nt_kinetics="approximate", rec_kinetics="approximate",
                 receptors=None):
        if nt_kinetics not in K.NT_KINETICS:
            raise ValueError(f"unknown neurotransmitter kinetics {nt_kinetics!r}")
        if rec_kinetics not in K.REC_KINETICS:
            raise ValueError(f"unknown receptor kinetics {rec_kinetics!r}")
        self.nt_kinetics = nt_kinetics
        self.rec_kinetics = rec_kinetics
        self.receptors = receptors if receptors is not None \
            else R.IonotropicReceptors(rec_kinetics)

    @property
    def n_types(self):
        return self.receptors.n_types

    @property
    def type_names(self):
        return self.receptors.type_names

    def config_key(self):
        return (type(self), self.nt_kinetics, self.rec_kinetics,
                self.receptors.config_key())

    def __hash__(self):
        return hash(self.config_key())

    def __eq__(self, other):
        return isinstance(other, NeuronModel) and self.config_key() == other.config_key()

    # -- state construction ---------------------------------------------------
    def init_state(self, n, device="cpu", **overrides):
        """The state of ``n`` identical neurons on ``device``: built on the
        host (`init_state_host`) and moved to the device once."""
        return {k: torch.from_numpy(v).to(device)
                for k, v in self.init_state_host(n, **overrides).items()}

    def init_state_host(self, n, **overrides):
        """The state as NumPy arrays.  ``overrides`` set per-field initial
        values (a scalar or an (n,) array)."""
        nk = (n, self.n_types)
        s = {}
        for f, d in self.FIELDS.items():
            s[f] = np.full((n,), d, np.float32)
        for f, d in self.BOOL_FIELDS.items():
            s[f] = np.full((n,), d, bool)
        for f, d in self.INT_FIELDS.items():
            s[f] = np.full((n,), d, np.int32)
        s["is_spiking"] = np.zeros((n,), bool)
        s["last_firing_time"] = np.full((n,), NEVER, np.int32)

        # neurotransmitters: none inserted by default
        s["nt$t"] = np.zeros(nk, np.float32)
        s["nt$mask"] = np.zeros(nk, bool)
        for f, d in K.NT_PARAM_DEFAULTS[self.nt_kinetics].items():
            s[f] = np.full(nk, d, np.float32)

        # receptors: none inserted by default
        s.update(self.receptors.init_fields(n))

        for key, val in overrides.items():
            if key not in s:
                raise KeyError(f"unknown state field {key!r} for {self.name}")
            arr = s[key]
            s[key] = np.broadcast_to(
                np.asarray(val, arr.dtype), arr.shape).copy()
        return s

    # -- receptor / neurotransmitter insertion --------------------------------
    def type_index(self, type_name):
        if type_name not in self.type_names:
            raise ValueError(
                f"unknown neurotransmitter type {type_name!r}; "
                f"available types: {self.type_names}")
        return self.type_names.index(type_name)

    def insert_receptor(self, state, type_name, **params):
        self.type_index(type_name)  # validate the name
        return self.receptors.insert(state, type_name, **params)

    def insert_neurotransmitter(self, state, type_name, **params):
        k = self.type_index(type_name)
        state = dict(state)
        state["nt$mask"] = R.set_col(state["nt$mask"], k, True)
        for p, v in params.items():
            key = f"nt${p}"
            state[key] = R.set_col(state[key], k, v)
        return state

    # -- hooks ----------------------------------------------------------------
    def pre_update(self, s):
        """Bookkeeping before integration.  Default no-op."""
        return s

    def deltas(self, s, i, fns=TORCH_FNS):
        raise NotImplementedError

    def handle_spiking(self, s):
        raise NotImplementedError

    # -- the IterateAndSpike template -----------------------------------------
    def step(self, s, i, t_input=None, t_valid=None, skip_nt=False,
             fns=TORCH_FNS):
        """One step over all N neurons, in the reference's order:
        pre_update -> receptors -> deltas -> v -= receptor dv -> NT release
        (new v, previous step's spike flag) -> handle_spiking.
        ``skip_nt=True`` skips the NT update, a masked no-op when no
        neurotransmitter is inserted."""
        s = dict(s)
        s = self.pre_update(s)

        if t_input is not None:
            s.update(self.receptors.update_kinetics(s, t_input, t_valid))
            # receptor currents use the pre-update voltage
            s.update(self.receptors.set_currents(s, s["v"]))
            rec_dv = self.receptors.receptor_dv(s)
        else:
            rec_dv = 0.0

        d = self.deltas(s, i, fns)
        new = {k: s[k] + dv for k, dv in d.items()}
        new["v"] = new["v"] - rec_dv
        s.update(new)

        if not skip_nt:
            s["nt$t"] = K.apply_t_changes(
                self.nt_kinetics, s, s["v"], s["is_spiking"])

        s, spikes = self.handle_spiking(s)
        s["is_spiking"] = spikes
        return s, spikes

    # -- spike handlers ---------------------------------------------------------
    @staticmethod
    def _handle_refractory_reset(s):
        """LIF-style handler with a refractory period: a neuron out of its
        refractory period spikes at v >= v_th; v -> v_reset while
        refractory or on a spike; the count falls by 1 per step and is set
        to tref / dt on a spike."""
        in_refractory = s["refractory_count"] > 0.0
        crossed = s["v"] >= s["v_th"]
        spikes = torch.logical_and(torch.logical_not(in_refractory), crossed)
        s = dict(s)
        s["v"] = torch.where(in_refractory | spikes, s["v_reset"], s["v"])
        s["refractory_count"] = torch.where(
            in_refractory, s["refractory_count"] - 1.0,
            torch.where(spikes, s["tref"] / s["dt"], s["refractory_count"]))
        return s, spikes

    @staticmethod
    def _handle_adaptive(s):
        """Adaptive handler: the refractory reset, and w += beta on a
        spike."""
        in_refractory = s["refractory_count"] > 0.0
        crossed = s["v"] >= s["v_th"]
        spikes = torch.logical_and(torch.logical_not(in_refractory), crossed)
        s = dict(s)
        s["v"] = torch.where(in_refractory | spikes, s["v_reset"], s["v"])
        s["w"] = torch.where(spikes, s["w"] + s["beta"], s["w"])
        s["refractory_count"] = torch.where(
            in_refractory, s["refractory_count"] - 1.0,
            torch.where(spikes, s["tref"] / s["dt"], s["refractory_count"]))
        return s, spikes

    @staticmethod
    def _handle_izhikevich(s):
        """Izhikevich handler: v >= v_th -> v = c, w += d."""
        spikes = s["v"] >= s["v_th"]
        s = dict(s)
        s["v"] = torch.where(spikes, s["c"], s["v"])
        s["w"] = torch.where(spikes, s["w"] + s["d"], s["w"])
        return s, spikes

    @staticmethod
    def _handle_simple_reset(s):
        """Simple leaky handler: v >= v_th -> v = v_reset, no refractory
        period."""
        spikes = s["v"] >= s["v_th"]
        s = dict(s)
        s["v"] = torch.where(spikes, s["v_reset"], s["v"])
        return s, spikes

    @staticmethod
    def _handle_peak_detection(s, last_voltage):
        """Hodgkin-Huxley and Morris-Lecar spike detection: a spike where
        v is above threshold, was rising and has just stopped rising."""
        increasing_now = last_voltage < s["v"]
        crossed = s["v"] > s["v_th"]
        spikes = crossed & s["was_increasing"] & torch.logical_not(
            increasing_now)
        s = dict(s)
        s["was_increasing"] = increasing_now
        return s, spikes


def get_neurotransmitter_concentrations(state):
    """(N, K) concentrations and presence mask."""
    return state["nt$t"], state["nt$mask"]


def run_static_input(model, state, input_current, iterations, generator=None,
                     gaussian=None):
    """`run_static_input_integrate_and_fire` (integrate_and_fire/mod.rs:
    40-58): ``iterations`` steps of ``model`` under a constant current,
    each scaled by a `utils.distribution.limited_distr` draw of
    ``gaussian`` ((mean, std, minimum, maximum)) where given, from
    ``generator`` (a `torch.Generator` on the state's device; a fresh one
    seeded 0 where None).  Returns the final state and the
    (iterations, N) voltage history."""
    from ..utils.distribution import limited_distr

    if gaussian is not None and generator is None:
        generator = torch.Generator(device=state["v"].device)
        generator.manual_seed(0)
    voltages = []
    for _ in range(iterations):
        i = input_current
        if gaussian is not None:
            i = input_current * limited_distr(
                generator, *gaussian, shape=tuple(state["v"].shape))
        state, _ = model.step(state, i)
        voltages.append(state["v"])
    return state, torch.stack(voltages)


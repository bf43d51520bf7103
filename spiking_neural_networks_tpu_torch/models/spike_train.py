"""Spike-train stimulus generators and neural refractoriness, vectorized.

PyTorch counterpart of ``spiking_neural_networks_tpu/models/spike_train.py``.
Spike trains are pure sources: ``step(state, generator, clock) -> (state,
spikes)``.  Poisson randomness draws from an explicit `torch.Generator` on
the state's device in place of the JAX package's threaded key; the two
streams differ, so Poisson parity is statistical (firing rates), as the
JAX package's own tests treat it.  Every other train is deterministic.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import NEVER
from ..ops import kinetics as K
from ..ops import receptors as R


# ---------------------------------------------------------------------------
# Neural refractoriness: the shape of a spike train's effect on a coupled
# neuron as a function of the time since its last firing.
# ---------------------------------------------------------------------------


def delta_dirac_effect(k, a, time_difference, v_resting, dt):
    """`DeltaDiracRefractoriness`: a * exp((-1 / (k / dt)) * dt_diff^2)
    + v_resting."""
    return a * torch.exp((-1.0 / (k / dt))
                         * (time_difference * time_difference)) + v_resting


def exponential_decay_effect(k, a, time_difference, v_resting, dt):
    """`ExponentialDecayRefractoriness`: a * exp((-1 / (k / dt)) * dt_diff)
    + v_resting."""
    return a * torch.exp((-1.0 / (k / dt)) * time_difference) + v_resting


REFRACTORINESS = {
    "delta_dirac": delta_dirac_effect,
    "exponential_decay": exponential_decay_effect,
}


def refractoriness_effect(kind, state, timestep):
    """The source term a train lends a coupled neuron, without the
    postsynaptic conductance: ``v_resting`` where the train never fired,
    else the refractoriness effect of ``timestep - last_firing_time``."""
    lft = state["last_firing_time"]
    a = state["v_th"] - state["v_resting"]
    dt_diff = (timestep - lft).to(torch.float32)
    effect = REFRACTORINESS[kind](state["refractoriness$k"], a, dt_diff,
                                  state["v_resting"], state["dt"])
    return torch.where(lft == NEVER, state["v_resting"], effect)


# ---------------------------------------------------------------------------
# Spike train models
# ---------------------------------------------------------------------------


class SpikeTrainModel:
    """Base for spike-train sources.  Subclasses define ``FIELDS`` /
    ``INT_FIELDS`` and ``step``."""

    name = "spike_train_base"
    FIELDS: dict = {}
    INT_FIELDS: dict = {}
    n_types = R.N_IONOTROPIC
    type_names = R.IONOTROPIC_TYPES
    needs_rng = False

    def __init__(self, nt_kinetics="approximate", refractoriness="delta_dirac"):
        if refractoriness not in REFRACTORINESS:
            raise ValueError(f"unknown refractoriness {refractoriness!r}")
        if nt_kinetics not in K.NT_KINETICS:
            raise ValueError(f"unknown neurotransmitter kinetics "
                             f"{nt_kinetics!r}")
        self.nt_kinetics = nt_kinetics
        self.refractoriness = refractoriness

    def config_key(self):
        return (type(self), self.nt_kinetics, self.refractoriness)

    def __hash__(self):
        return hash(self.config_key())

    def __eq__(self, other):
        return isinstance(other, SpikeTrainModel) \
            and self.config_key() == other.config_key()

    def init_state(self, n, device="cpu", **overrides):
        """The state of ``n`` identical trains on ``device``, built on the
        host (`init_state_host`) and moved once."""
        return {k: torch.from_numpy(v).to(device)
                for k, v in self.init_state_host(n, **overrides).items()}

    def init_state_host(self, n, **overrides):
        """The state as NumPy arrays; ``overrides`` set per-field initial
        values (a scalar or an (n,) array)."""
        nk = (n, self.n_types)
        s = {}
        base = dict(v=0.0, v_th=30.0, v_resting=0.0, dt=0.1)
        base.update(self.FIELDS)
        for f, d in base.items():
            s[f] = np.full((n,), d, np.float32)
        for f, d in self.INT_FIELDS.items():
            s[f] = np.full((n,), d, np.int32)
        s["is_spiking"] = np.zeros((n,), bool)
        s["last_firing_time"] = np.full((n,), NEVER, np.int32)
        # the refractoriness decay k (default 10000)
        s["refractoriness$k"] = np.full((n,), 10000.0, np.float32)
        s["nt$t"] = np.zeros(nk, np.float32)
        s["nt$mask"] = np.zeros(nk, bool)
        for f, d in K.NT_PARAM_DEFAULTS[self.nt_kinetics].items():
            s[f] = np.full(nk, d, np.float32)
        for key, val in overrides.items():
            if key not in s:
                raise KeyError(f"unknown state field {key!r} for {self.name}")
            s[key] = np.broadcast_to(
                np.asarray(val, s[key].dtype), s[key].shape).copy()
        return s

    def type_index(self, type_name):
        if type_name not in self.type_names:
            raise ValueError(
                f"unknown neurotransmitter type {type_name!r}; "
                f"available types: {self.type_names}")
        return self.type_names.index(type_name)

    def insert_neurotransmitter(self, state, type_name, **params):
        k = self.type_index(type_name)
        state = dict(state)
        state["nt$mask"] = R.set_col(state["nt$mask"], k, True)
        for p, v in params.items():
            state[f"nt${p}"] = R.set_col(state[f"nt${p}"], k, v)
        return state

    def effect(self, state, timestep):
        return refractoriness_effect(self.refractoriness, state, timestep)

    def _finish(self, s, spikes):
        """Set the spike flag and voltage, then release neurotransmitter:
        unlike neurons, trains release after setting the new spike flag."""
        s["is_spiking"] = spikes
        s["v"] = torch.where(spikes, s["v_th"], s["v_resting"])
        s["nt$t"] = K.apply_t_changes(self.nt_kinetics, s, s["v"], spikes)
        return s

    def step(self, s, generator, clock):
        raise NotImplementedError


class PoissonSpikeTrain(SpikeTrainModel):
    """`PoissonNeuron`: fires i.i.d. with
    ``chance_of_firing = 1 / ((1000 / dt) / hertz)``."""

    name = "poisson"
    FIELDS = dict(chance_of_firing=0.0)
    needs_rng = True

    @staticmethod
    def rate_to_chance(hertz, dt):
        return 1.0 / ((1000.0 / dt) / hertz)

    def init_from_firing_rate(self, n, hertz, dt=0.1, device="cpu",
                              **overrides):
        return self.init_state(
            n, device=device, chance_of_firing=self.rate_to_chance(hertz, dt),
            dt=dt, **overrides)

    def step(self, s, generator, clock, u=None):
        """``u``: the step's uniform draws where the caller drew them (a
        sharded train's rows of its whole-plane draw)."""
        s = dict(s)
        if u is None:
            u = torch.rand(s["v"].shape, generator=generator,
                           device=s["v"].device)
        spikes = u <= s["chance_of_firing"]
        return self._finish(s, spikes), spikes


class RateSpikeTrain(SpikeTrainModel):
    """`RateSpikeTrain`: fires deterministically every ``rate`` ms."""

    name = "rate"
    FIELDS = dict(rate=0.0, step=0.0)

    def step(self, s, generator, clock):
        s = dict(s)
        stepped = s["step"] + s["dt"]
        spikes = torch.logical_and(s["rate"] != 0.0, stepped >= s["rate"])
        s["step"] = torch.where(spikes, 0.0, stepped)
        return self._finish(s, spikes), spikes


class PresetSpikeTrain(SpikeTrainModel):
    """`PresetSpikeTrain`: cycles through a list of inter-spike intervals.
    ``firing_times`` is a padded (N, L) array with per-neuron length
    ``firing_times_len``."""

    name = "preset"
    FIELDS = dict(internal_clock=0.0)
    INT_FIELDS = dict(counter=0)

    def init_state_host(self, n, firing_times=None, **overrides):
        s = super().init_state_host(n, **overrides)
        if firing_times is None:
            firing_times = [[0.0]]
        ft = np.asarray(firing_times, np.float32)
        if ft.ndim == 1:
            ft = np.broadcast_to(ft[None, :], (n, ft.shape[0]))
        s["firing_times"] = ft.copy()
        s["firing_times_len"] = np.full((n,), ft.shape[1], np.int32)
        return s

    def step(self, s, generator, clock):
        s = dict(s)
        internal = s["internal_clock"] + s["dt"]
        # a (1, L) default broadcasts over the trains, as take_along_axis
        ft = s["firing_times"].expand(s["counter"].shape[0], -1)
        current_target = torch.gather(
            ft, 1, s["counter"][:, None].long())[:, 0]
        spikes = internal > current_target
        counter = torch.where(spikes, s["counter"] + 1, s["counter"])
        counter = torch.where(counter >= s["firing_times_len"], 0, counter)
        s["internal_clock"] = torch.where(spikes, 0.0, internal)
        s["counter"] = counter.to(torch.int32)
        return self._finish(s, spikes), spikes


class BCMPoissonSpikeTrain(PoissonSpikeTrain):
    """`BCMPoissonNeuron`: a Poisson source with BCM activity bookkeeping
    (faithful to the reference, including ``num_spikes`` never
    resetting)."""

    name = "bcm_poisson"
    FIELDS = dict(chance_of_firing=0.0, average_activity=0.0,
                  current_activity=0.0, period=3.0, firing_rate_clock=0.0,
                  firing_rate_window=500.0)
    INT_FIELDS = dict(num_spikes=0)
    needs_rng = True

    def step(self, s, generator, clock, u=None):
        """``u``: the step's uniform draws where the caller drew them (a
        sharded train's rows of its whole-plane draw)."""
        s = dict(s)
        if u is None:
            u = torch.rand(s["v"].shape, generator=generator,
                           device=s["v"].device)
        spikes = u <= s["chance_of_firing"]
        # instantaneous activity: the voltage delta
        target = torch.where(spikes, s["v_th"], s["v_resting"])
        s["current_activity"] = target - s["v"]
        s["num_spikes"] = s["num_spikes"] + spikes.to(torch.int32)
        clock_f = s["firing_rate_clock"] + s["dt"]
        hit = clock_f >= s["firing_rate_window"]
        activity = s["num_spikes"].to(torch.float32) / \
            (s["firing_rate_window"] * s["dt"])
        s["firing_rate_clock"] = torch.where(hit, 0.0, clock_f)
        s["current_activity"] = torch.where(hit, activity,
                                            s["current_activity"])
        avg = s["average_activity"]
        s["average_activity"] = torch.where(
            hit, avg - avg / s["period"] + activity / s["period"], avg)
        return self._finish(s, spikes), spikes

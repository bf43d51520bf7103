"""Fit one neuron model's parameters to another's spiking behavior.

PyTorch counterpart of ``spiking_neural_networks_tpu/fitting/fitting.py``
(the reference's ``backend/src/fitting/mod.rs``): the GA population's
coupled simulations (spike train -> presynaptic -> postsynaptic neuron,
`iterate_coupled_spiking_neurons_and_spike_train`, neuron/mod.rs:157-221)
run batched over the population, one step loop of tensor operations on
the states' device (the JAX package runs one vmapped ``lax.scan``; there
is no kernel).  A Poisson train draws from a `torch.Generator` in place
of a JAX key; a Rate or Preset train is deterministic.

The `ActionPotentialSummary` (fitting/mod.rs:26-77) fields reduce to
running statistics (first and last spike time and spike count), since
``mean(diff(peaks)) == (last - first) / len(peaks)``.
"""

from __future__ import annotations

import torch

from ..models.base import NEVER
from ..models.spike_train import refractoriness_effect
from .ga import GeneticAlgorithmParameters, genetic_algo


class ActionPotentialSummary:
    """fitting/mod.rs:26-36."""

    def __init__(self, pre_diff, post_diff, num_pre, num_post):
        self.average_pre_spike_time_difference = pre_diff
        self.average_post_spike_time_difference = post_diff
        self.num_pre_spikes = num_pre
        self.num_post_spikes = num_post

    def as_array(self):
        return torch.tensor([self.average_pre_spike_time_difference,
                             self.average_post_spike_time_difference,
                             self.num_pre_spikes, self.num_post_spikes],
                            dtype=torch.float32)


def summary_from_stats(first_pre, last_pre, n_pre, first_post, last_post,
                       n_post):
    """avg spike-time difference = sum(diff(peaks)) / len(peaks)
    = (last - first) / count (fitting/mod.rs:54-66); 0 when no spikes."""
    pre_diff = torch.where(n_pre > 0, (last_pre - first_pre) / n_pre, 0.0)
    post_diff = torch.where(n_post > 0, (last_post - first_post) / n_post,
                            0.0)
    return torch.stack([pre_diff, post_diff, n_pre, n_post], dim=-1)


def compare_summary(s1, s2):
    """`compare_summary` (fitting/mod.rs:173-190): the sum of squared
    field differences; NaN -> inf."""
    score = torch.sum((s1 - s2) ** 2, dim=-1)
    return torch.where(torch.isnan(score), torch.inf, score)


class SummaryScalingDefaults:
    """fitting/mod.rs:80-97."""

    def __init__(self, default_amplitude_scale=70.0,
                 default_time_difference_scale=800.0,
                 default_num_peaks_scale=10.0):
        self.default_amplitude_scale = default_amplitude_scale
        self.default_time_difference_scale = default_time_difference_scale
        self.default_num_peaks_scale = default_num_peaks_scale


def scale_summary(summary, time_difference_scale, num_peaks_scale):
    """`scale_summary` (fitting/mod.rs:158-169)."""
    scales = torch.tensor([float(time_difference_scale),
                           float(time_difference_scale),
                           float(num_peaks_scale), float(num_peaks_scale)],
                          dtype=torch.float32, device=summary.device)
    return summary / scales


def run_coupled_trial(neuron_model, st_model, neuron_state, st_state,
                      iterations, electrical=True, chemical=False,
                      generator=None):
    """Batched `iterate_coupled_spiking_neurons_and_spike_train`
    (neuron/mod.rs:157-221) over any leading batch shape, on the states'
    device.

    ``neuron_state`` holds the presynaptic AND postsynaptic neuron: fields
    are stacked (..., 2) with index 0 = pre, 1 = post (neurotransmitter
    fields (..., 2, K), `_stack_pair`).  A Poisson train draws from
    ``generator`` (a fresh one seeded 0 where None).  Returns the summary
    statistics (..., 4)."""
    dev = neuron_state["v"].device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    nstate, ststate = dict(neuron_state), dict(st_state)
    shape = nstate["v"].shape                                 # (..., 2)
    first = torch.zeros(shape, device=dev)
    last = torch.zeros(shape, device=dev)
    count = torch.zeros(shape, device=dev)
    for timestep in range(iterations):
        pre_v = nstate["v"][..., 0]
        post_v = nstate["v"][..., 1]
        if electrical:
            effect = refractoriness_effect(st_model.refractoriness, ststate,
                                           timestep)
            # spike_train_gap_junction (neuron/mod.rs:119-137): a train
            # that never fired lends bare v_resting, WITHOUT the
            # postsynaptic conductance factor
            never = ststate["last_firing_time"] == NEVER
            pre_current = torch.where(
                never, effect, nstate["gap_conductance"][..., 0] * effect)
            post_current = nstate["gap_conductance"][..., 1] \
                * (pre_v - post_v)
        else:
            pre_current = torch.zeros_like(pre_v)
            post_current = torch.zeros_like(post_v)
        if chemical:
            # the pair axis BEFORE the type axis: the pre slot is driven by
            # the train's release, the post slot by the PRE neuron's
            t_in = torch.stack([ststate["nt$t"], nstate["nt$t"][..., 0, :]],
                               dim=-2)
            t_valid = torch.stack([ststate["nt$mask"],
                                   nstate["nt$mask"][..., 0, :]], dim=-2)
        ststate, st_spikes = st_model.step(ststate, generator, timestep)
        ststate["last_firing_time"] = torch.where(
            st_spikes, timestep, ststate["last_firing_time"])
        i = torch.stack([pre_current, post_current], dim=-1)
        if chemical:
            nstate, spikes = neuron_model.step(nstate, i, t_in, t_valid)
        else:
            nstate, spikes = neuron_model.step(nstate, i)
        nstate["last_firing_time"] = torch.where(
            spikes, timestep, nstate["last_firing_time"])
        ts = float(timestep)
        first = torch.where(spikes & (count == 0), ts, first)
        last = torch.where(spikes, ts, last)
        count = count + spikes.to(torch.float32)
    return summary_from_stats(first[..., 0], last[..., 0], count[..., 0],
                              first[..., 1], last[..., 1], count[..., 1])


def _stack_pair(state):
    """Stack a state into the pre/post pair layout: scalar fields become
    (..., 2); (..., K) neurotransmitter fields become (..., 2, K), keeping
    the type axis LAST as every kinetics and receptor step expects."""
    return {k: torch.stack([v, v], dim=(-2 if v.dim() >= 2 else -1))
            for k, v in state.items()}


def _to(state, device):
    return {k: torch.as_tensor(v).to(device) for k, v in state.items()}


class FittingSettings:
    """`FittingSettings` (fitting/mod.rs:248-274).

    ``converter(params)`` maps the population's decoded parameters to
    state-field overrides (a dict of scalars or tensors) for the neuron
    model.  It is called once per generation on the (n_params, n_pop)
    transpose of the decoded population, so ``params[i]`` is parameter
    ``i`` of every member: a converter that indexes its argument (as the
    JAX package's, which is vmapped over the rows) works unchanged."""

    def __init__(self, neuron_model, st_model, spike_train_states,
                 reference_summaries, scaling_factors, iterations, converter,
                 electrical_synapse=True, chemical_synapse=False):
        self.neuron_model = neuron_model
        self.st_model = st_model
        self.spike_train_states = spike_train_states
        self.reference_summaries = reference_summaries
        self.scaling_factors = scaling_factors
        self.iterations = iterations
        self.converter = converter
        self.electrical_synapse = electrical_synapse
        self.chemical_synapse = chemical_synapse


def get_reference_summary(neuron_model, neuron_state, st_model, st_state,
                          iterations, electrical=True, chemical=False,
                          device="cuda"):
    """`get_reference_summary` (fitting/mod.rs:192-246) for one neuron
    configuration (the state holds one neuron, duplicated into pre and
    post), on ``device`` (the states are moved there)."""
    paired = _stack_pair(_to(neuron_state, device))
    return run_coupled_trial(neuron_model, st_model, paired,
                             _to(st_state, device), iterations, electrical,
                             chemical)


def population_state(template, converter, decoded):
    """The (n_pop,) batch of ``template`` (one neuron's fields) with the
    converter's overrides for the decoded population (n_pop, n_params)."""
    n_pop = decoded.shape[0]
    base = {k: v.expand((n_pop,) + v.shape).clone()
            for k, v in template.items()}
    for k, v in converter(decoded.T).items():
        v = torch.as_tensor(v, dtype=base[k].dtype, device=decoded.device)
        if v.dim() == 1:
            v = v.reshape((n_pop,) + (1,) * (base[k].dim() - 1))
        base[k] = torch.broadcast_to(v, base[k].shape).clone()
    return base


def population_scores(settings, trains, template, refs, scales, decoded):
    """The summed scaled-summary distance of each member of the decoded
    population (n_pop, n_params) across the spike-train states ``trains``
    (``settings.spike_train_states`` on the population's device)."""
    n_pop = decoded.shape[0]
    paired = _stack_pair(population_state(template, settings.converter,
                                          decoded))
    total = torch.zeros((n_pop,), dtype=torch.float32, device=decoded.device)
    for s, st_state in enumerate(trains):
        # a train state holds one generator: broadcast it to the population
        st_b = {k: v[0].expand((n_pop,) + v[0].shape).clone()
                for k, v in st_state.items()}
        summary = run_coupled_trial(
            settings.neuron_model, settings.st_model, paired, st_b,
            settings.iterations, settings.electrical_synapse,
            settings.chemical_synapse)
        scaled = scale_summary(summary, scales[s][0], scales[s][1])
        ref_scaled = scale_summary(refs[s], scales[s][0], scales[s][1])
        total = total + compare_summary(scaled, ref_scaled)
    return total


def fit_neuron_to_neuron(settings, ga_params=None, generator=None,
                         verbose=False, device="cuda"):
    """`fit_neuron_to_neuron` (fitting/mod.rs:411+): the GA minimizing the
    summed scaled-summary distance across every spike-train setting, on
    ``device`` (or the device of ``generator``; the train states and
    reference summaries are moved there).  Returns (best_params,
    best_score, all_scores) as `genetic_algo` does."""
    if ga_params is None:
        ga_params = GeneticAlgorithmParameters()
    if generator is not None:
        device = generator.device
    refs = [torch.as_tensor(r).to(device, torch.float32)
            for r in settings.reference_summaries]
    scales = [(float(a), float(b)) for a, b in settings.scaling_factors]
    trains = [_to(st, device) for st in settings.spike_train_states]
    template = {k: v[0] for k, v in settings.neuron_model.init_state(
        1, device=device).items()}
    return genetic_algo(
        lambda decoded: population_scores(settings, trains, template, refs,
                                          scales, decoded),
        ga_params, generator, verbose, device)

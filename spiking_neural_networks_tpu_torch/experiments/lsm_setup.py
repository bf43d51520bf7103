"""Liquid-state-machine helpers, on the port's `lixirnet`.

PyTorch counterpart of ``experiments/lsm_setup.py``, the port of the
reference's ``interface/experiments/lsm_setup.py``: random liquid weights
normalized to a target spectral radius, spike-train on/off setup
functions, and the return-to-baseline stability metric.  The weights are
NumPy draws in the JAX script's order; `build_dopa_liquid_network` builds
its lattices on ``device`` (``"cuda"`` by default).
"""

from __future__ import annotations

import numpy as np


def spectral_radius(w):
    return float(np.abs(np.linalg.eigvals(w)).max())


def generate_liquid_weights(size, minimum=0.0, maximum=1.0,
                            connectivity=0.25, scalar=0.5, rng=None):
    """Random sparse weights scaled so the spectral radius is ``1/scalar``
    (echo-state scaling; lsm_setup.py:8-21)."""
    rng = rng or np.random.default_rng()
    w = np.zeros((size, size))
    connections = rng.random((size, size)) < connectivity
    weights = np.abs(rng.normal(minimum, maximum, (size, size)))
    w[connections] = weights[connections]
    np.fill_diagonal(w, 0)
    return w / (spectral_radius(w) * scalar)


def generate_start_firing(cue_firing_rate):
    def start_firing(neuron):
        neuron.chance_of_firing = cue_firing_rate
        return neuron
    return start_firing


def stop_firing(neuron):
    neuron.chance_of_firing = 0.0
    return neuron


def determine_return_to_baseline(voltages, settling_period, on_phase,
                                 off_phase, tolerance):
    """Steps after the disturbance ends until the running-mean voltage
    re-enters ``tolerance`` of the pre-disturbance baseline
    (lsm_setup.py:36-44).

    Reference quirk, replicated faithfully: the reference IGNORES its
    ``settling_period`` argument and hardcodes the baseline window start
    at 1000 (the reference's `interface/experiments/lsm_setup.py:37`) —
    its configs all run with off_phase > 1000, so reference TOMLs replay
    identically here.  Below that scale (smoke runs) a hardcoded 1000
    would produce an empty window, so the parameter is honored there."""
    start = 1000 if off_phase > 1000 else settling_period
    baseline = np.array(voltages[start:off_phase]).mean()
    for i in range(off_phase):
        tail = np.array(voltages[off_phase + on_phase + i:])
        if tail.size == 0:
            break
        if abs(baseline - tail.mean()) < tolerance:
            return i
    return off_phase


def build_dopa_liquid_network(sp, cs, w, rng, w_inh=None, setup_neuron=None,
                              device="cuda"):
    """Shared liquid-network builder for the TOML-grid manifold pipelines
    (the reference's `interface/experiments/liquid_manifold_generation.py:
    139-228`, `liquid_custom_manifold_generation.py:169-238`): a Dopa
    Izhikevich excitatory liquid (optional GABA inhibitory pool) plus a
    Dopa Poisson cue lattice, chemical synapses.

    Returns (network, exc_id, inh_id, cue_id).  The reference assigns the
    swapped gmax pair (ampa_g <- nmda_g and vice versa) — replicated
    faithfully, as in dopamine_liquid_interaction._run_grid_point.
    """
    from .. import lixirnet as ln

    exc_n, inh_n = sp["exc_n"], sp["inh_n"]
    e1, i1, c1 = 0, 1, 2

    glu_neuro = ln.ApproximateNeurotransmitter(
        clearance_constant=cs["glutamate_clearance"])
    exc_nts = ln.DopaGluGABAApproximateNeurotransmitters()
    exc_nts.set_neurotransmitter(
        ln.DopaGluGABANeurotransmitterType.Glutamate, glu_neuro)
    gaba_neuro = ln.ApproximateNeurotransmitter(
        clearance_constant=cs["gabaa_clearance"])
    inh_nts = ln.DopaGluGABAApproximateNeurotransmitters()
    inh_nts.set_neurotransmitter(
        ln.DopaGluGABANeurotransmitterType.GABA, gaba_neuro)

    glu = ln.GlutamateReceptor()
    glu.ampa_g = cs["nmda_g"]     # swapped in the reference — faithful
    glu.nmda_g = cs["ampa_g"]
    gaba = ln.GABAReceptor()
    gaba.g = cs["gabaa_g"]
    receptors = ln.DopaGluGABAReceptors()
    receptors.set_receptor(ln.DopaGluGABANeurotransmitterType.Glutamate, glu)
    receptors.set_receptor(ln.DopaGluGABANeurotransmitterType.GABA, gaba)

    exc_neuron = ln.DopaIzhikevichNeuron()
    exc_neuron.set_neurotransmitters(exc_nts)
    exc_neuron.set_receptors(receptors)
    poisson_neuron = ln.DopaPoissonNeuron()
    poisson_neuron.set_neurotransmitters(exc_nts)

    exc_lattice = ln.DopaIzhikevichLattice(e1, device=device)
    exc_lattice.populate(exc_neuron, exc_n, exc_n)
    if setup_neuron is not None:
        exc_lattice.apply(setup_neuron)
    p2i = exc_lattice.position_to_index
    exc_lattice.connect(
        lambda x, y: bool(float(w[p2i[x]][p2i[y]]) != 0),
        lambda x, y: float(w[p2i[x]][p2i[y]]))
    exc_lattice.update_grid_history = True

    cue = ln.DopaPoissonLattice(c1, device=device)
    cue.populate(poisson_neuron, exc_n, exc_n)

    if not sp["exc_only"]:
        inh_neuron = ln.DopaIzhikevichNeuron()
        inh_neuron.set_neurotransmitters(inh_nts)
        inh_neuron.set_receptors(receptors)
        inh_lattice = ln.DopaIzhikevichLattice(i1, device=device)
        inh_lattice.populate(inh_neuron, inh_n, inh_n)
        if setup_neuron is not None:
            inh_lattice.apply(setup_neuron)
        q2i = inh_lattice.position_to_index
        inh_lattice.connect(
            lambda x, y: bool(float(w_inh[q2i[x]][q2i[y]]) != 0),
            lambda x, y: float(w_inh[q2i[x]][q2i[y]]))
        network = ln.DopaIzhikevichNetwork.generate_network(
            [exc_lattice, inh_lattice], [cue])
        network.connect(
            i1, e1,
            lambda x, y: rng.uniform(0, 1) < cs["inh_to_exc_connectivity"],
            lambda x, y: cs["inh_to_exc_weight"])
        network.connect(
            e1, i1,
            lambda x, y: rng.uniform(0, 1) < cs["exc_to_inh_connectivity"],
            lambda x, y: cs["exc_to_inh_weight"])
    else:
        network = ln.DopaIzhikevichNetwork.generate_network(
            [exc_lattice], [cue])

    network.set_dt(sp["dt"])
    network.electrical_synapse = False
    network.chemical_synapse = True
    return network, e1, i1, c1

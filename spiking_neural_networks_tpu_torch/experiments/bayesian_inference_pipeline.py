"""Hopfield-attractor Bayesian inference with dopamine biasing, on the
port's `lixirnet`.

PyTorch counterpart of ``experiments/bayesian_inference_pipeline.py``, the
port of the reference's flagship experiment
(the reference's `interface_gpu/experiments/bayesian_inference_pipeline.py`):
an excitatory lattice storing Hopfield memories (binary-pattern weights)
with an inhibitory pool, driven by a Poisson "main" cue lattice encoding a
distorted pattern, plus a second Poisson "bayesian" cue lattice releasing
dopamine that biases recall through D1/D2 receptor gain modulation.  The
recall accuracy is the correlation between per-neuron firing counts and the
stored patterns.  The lattices run on the card (``device="cuda"``, the
default) unless the caller names another device; the NumPy generator
draws stay in the JAX script's order, so one seed builds the same network.

Run:  python -m spiking_neural_networks_tpu_torch.experiments.\
bayesian_inference_pipeline [args.toml] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .pipeline_setup import (
    output_path,
    output_path,parse_toml, get_weights, weights_ie,
                            generate_patterns, generate_setup_neuron,
                            get_spike_train_setup_function,
                            find_peaks_above_threshold, determine_accuracy)

from .. import lixirnet as ln

DEFAULTS = {
    "simulation_parameters": dict(
        filename="bayesian_inference_output.json", iterations=1500,
        trials=2, exc_n=7, inh_n=3, num_patterns=2, p_on=0.5,
        correlation_threshold=10.0, weights_scalar=2.0,
        inh_weights_scalar=0.5, a=0.5, b=0.5, dt=1.0, distortion=0.15,
        main_firing_rate=0.01, bayesian_firing_rate=0.01,
        spike_train_to_exc=5.0, bayesian_to_exc=2.0, exc_to_inh=1.0,
        prob_of_exc_to_inh=0.5, d2=True, s_d2=0.5, s_d1=0.0,
        peak_threshold=-55.0, measure_window=0, c_m=25.0,
        glutamate_clearance=0.001, gabaa_clearance=0.001,
        dopamine_clearance=0.001, seed=0),
}


def run_trial(p, patterns, pattern_index, rng, with_dopamine_cue,
              device="cuda"):
    exc_n, inh_n = p["exc_n"], p["inh_n"]
    num = exc_n * exc_n

    w = get_weights(num, patterns, a=p["a"], b=p["b"],
                    scalar=p["weights_scalar"] / p["num_patterns"])
    w_ie = weights_ie(inh_n, p["inh_weights_scalar"], patterns,
                      p["num_patterns"])

    glu_neuro = ln.BoundedNeurotransmitterKinetics(
        clearance_constant=p["glutamate_clearance"])
    gaba_neuro = ln.BoundedNeurotransmitterKinetics(
        clearance_constant=p["gabaa_clearance"])
    dopa_neuro = ln.BoundedNeurotransmitterKinetics(
        clearance_constant=p["dopamine_clearance"])
    exc_nts = {ln.DopaGluGABANeurotransmitterType.Glutamate: glu_neuro}
    inh_nts = {ln.DopaGluGABANeurotransmitterType.GABA: gaba_neuro}
    dopa_nts = {ln.DopaGluGABANeurotransmitterType.Dopamine: dopa_neuro}

    glu = ln.GlutamateReceptor(ampa_r=ln.BoundedReceptorKinetics(r_max=10),
                               nmda_r=ln.BoundedReceptorKinetics(r_max=10))
    gabaa = ln.GABAReceptor()
    dopamine_rs = ln.DopamineReceptor(s_d1=p["s_d1"], s_d2=p["s_d2"])

    receptors = ln.DopaGluGABA()
    receptors.insert(ln.DopaGluGABANeurotransmitterType.Glutamate, glu)
    receptors.insert(ln.DopaGluGABANeurotransmitterType.GABA, gabaa)
    receptors.insert(ln.DopaGluGABANeurotransmitterType.Dopamine, dopamine_rs)

    exc_neuron = ln.IzhikevichNeuron()
    exc_neuron.set_synaptic_neurotransmitters(exc_nts)
    exc_neuron.set_receptors(receptors)
    inh_neuron = ln.IzhikevichNeuron()
    inh_neuron.set_synaptic_neurotransmitters(inh_nts)
    inh_neuron.set_receptors(receptors)
    poisson = ln.PoissonNeuron()
    poisson.set_synaptic_neurotransmitters(exc_nts)
    poisson_dopa = ln.PoissonNeuron()
    poisson_dopa.set_synaptic_neurotransmitters(dopa_nts)

    setup_neuron = generate_setup_neuron(c_m=p["c_m"], rng=rng)

    inh_lattice = ln.IzhikevichNeuronLattice(0, device=device)
    inh_lattice.populate(inh_neuron, inh_n, inh_n)
    inh_lattice.apply(setup_neuron)

    exc_lattice = ln.IzhikevichNeuronLattice(1, device=device)
    exc_lattice.populate(exc_neuron, exc_n, exc_n)
    exc_lattice.apply(setup_neuron)
    pos_to_idx = exc_lattice.position_to_index
    exc_lattice.connect(
        lambda x, y: bool(w[pos_to_idx[x]][pos_to_idx[y]] != 0),
        lambda x, y: float(w[pos_to_idx[x]][pos_to_idx[y]]))
    exc_lattice.update_grid_history = True

    spike_train_lattice = ln.PoissonLattice(2, device=device)
    spike_train_lattice.populate(poisson, exc_n, exc_n)

    cue_lattice = ln.PoissonLattice(3, device=device)
    cue_lattice.populate(poisson_dopa if with_dopamine_cue else poisson,
                         exc_n, exc_n)

    network = ln.IzhikevichNeuronNetwork()
    network.add_lattice(inh_lattice)
    network.add_lattice(exc_lattice)
    network.add_spike_train_lattice(spike_train_lattice)
    network.add_spike_train_lattice(cue_lattice)

    network.connect(0, 1, lambda x, y: True,
                    lambda x, y: float(w_ie[y[0] % inh_n, y[1] % inh_n]))
    network.connect(1, 0,
                    lambda x, y: rng.uniform() <= p["prob_of_exc_to_inh"],
                    lambda x, y: p["exc_to_inh"])
    network.connect(2, 1, lambda x, y: x == y,
                    lambda x, y: p["spike_train_to_exc"])
    network.connect(3, 1, lambda x, y: x == y,
                    lambda x, y: p["bayesian_to_exc"])
    network.set_dt(p["dt"])
    network.electrical_synapse = False
    network.chemical_synapse = True

    # main cue: the distorted target pattern
    network.apply_spike_train_lattice_given_position(
        2, get_spike_train_setup_function(
            patterns, pattern_index, p["distortion"],
            p["main_firing_rate"], exc_n, rng=rng))
    # bayesian cue: dopamine released from the same pattern's support
    network.apply_spike_train_lattice_given_position(
        3, get_spike_train_setup_function(
            patterns, pattern_index, p["distortion"],
            p["bayesian_firing_rate"], exc_n, rng=rng))

    network.run_lattices(p["iterations"])

    hist = np.stack(network.get_lattice(1).history)   # (T, exc_n, exc_n)
    peaks = [find_peaks_above_threshold(hist[:, i // exc_n, i % exc_n],
                                        p["peak_threshold"])
             for i in range(num)]
    accuracy = determine_accuracy(
        patterns, pattern_index, p["num_patterns"], p["measure_window"],
        peaks, exc_n, use_correlation_as_accuracy=True)
    firing_counts = np.array([len(pk) for pk in peaks])
    return accuracy, firing_counts


def main(argv=None):
    argv = sys.argv if argv is None else argv
    cli = argparse.ArgumentParser(
        prog=argv[0] if argv else None,
        description="Bayesian inference with dopamine biasing on the "
                    "port's lixirnet; without a TOML, the defaults.")
    cli.add_argument("toml", nargs="?", help="the pipeline's TOML")
    cli.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = cli.parse_args(list(argv)[1:])
    if args.toml is not None:
        with open(args.toml, "rb") as f:
            parsed = parse_toml(f)
        p = dict(DEFAULTS["simulation_parameters"])
        p.update(parsed.get("simulation_parameters", {}))
    else:
        p = dict(DEFAULTS["simulation_parameters"])

    rng = np.random.default_rng(p["seed"])
    results = []
    for trial in range(p["trials"]):
        patterns = generate_patterns(p["exc_n"] ** 2, p["p_on"],
                                     p["num_patterns"],
                                     p["correlation_threshold"], rng=rng)
        pattern_index = int(rng.integers(0, p["num_patterns"]))
        t0 = time.time()
        accuracy, counts = run_trial(p, patterns, pattern_index, rng,
                                     with_dopamine_cue=p["d2"],
                                     device=args.device)
        results.append(dict(trial=trial, pattern_index=pattern_index,
                            accuracy=bool(accuracy),
                            total_spikes=int(counts.sum()),
                            wall_s=round(time.time() - t0, 2)))
        print(results[-1], flush=True)

    with open(output_path(p["filename"]), "w") as f:
        json.dump(dict(parameters={k: v for k, v in p.items()},
                       results=results), f, indent=1)
    print("accuracy:",
          sum(r["accuracy"] for r in results) / len(results), flush=True)


if __name__ == "__main__":
    main()

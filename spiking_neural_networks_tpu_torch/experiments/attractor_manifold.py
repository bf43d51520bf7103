"""Attractor manifolds of Hopfield recall trajectories, on the port's
`lixirnet`.

PyTorch counterpart of ``experiments/attractor_manifold.py``, the port of
the reference's `interface/experiments/attractor_manifold_generation.py`
(+ the offline `attractor_manifold_plot.py` analysis): a Hopfield
excitatory/inhibitory network is cued toward each stored pattern over
several trials; the full voltage trajectories are recorded, embedded with
PCA, and the attractor structure is quantified — trajectories cued to the
same pattern should cluster (within-pattern spread < between-pattern
distance in the embedding).  The lattices run on the card
(``device="cuda"``, the default) unless the caller names another device;
the NumPy generator draws stay in the JAX script's order, so one seed
builds the same network.  The plot script (``experiments/
attractor_manifold_plot.py``) reads the firing-data JSON offline.

Run: python -m spiking_neural_networks_tpu_torch.experiments.\
attractor_manifold [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .pipeline_setup import (
    output_path, get_weights, weights_ie, generate_patterns,
                            generate_setup_neuron,
                            get_spike_train_setup_function,
                            find_peaks_above_threshold)

from .. import lixirnet as ln


def run_trial(w, w_ie, patterns, pattern_index, exc_n, inh_n, rng,
              iterations=800, distortion=0.1, cue_firing_rate=0.01,
              spike_train_to_exc=5.0, exc_to_inh=1.0, prob_exc_to_inh=0.5,
              dt=1.0, device="cuda"):
    glu_neuro = ln.BoundedNeurotransmitterKinetics(clearance_constant=0.001)
    gaba_neuro = ln.BoundedNeurotransmitterKinetics(clearance_constant=0.001)
    exc_nts = {ln.DopaGluGABANeurotransmitterType.Glutamate: glu_neuro}
    inh_nts = {ln.DopaGluGABANeurotransmitterType.GABA: gaba_neuro}

    glu = ln.GlutamateReceptor(ampa_r=ln.BoundedReceptorKinetics(r_max=10),
                               nmda_r=ln.BoundedReceptorKinetics(r_max=10))
    receptors = ln.DopaGluGABA()
    receptors.insert(ln.DopaGluGABANeurotransmitterType.Glutamate, glu)
    receptors.insert(ln.DopaGluGABANeurotransmitterType.GABA,
                     ln.GABAReceptor())

    exc_neuron = ln.IzhikevichNeuron()
    exc_neuron.set_synaptic_neurotransmitters(exc_nts)
    exc_neuron.set_receptors(receptors)
    inh_neuron = ln.IzhikevichNeuron()
    inh_neuron.set_synaptic_neurotransmitters(inh_nts)
    inh_neuron.set_receptors(receptors)
    poisson = ln.PoissonNeuron()
    poisson.set_synaptic_neurotransmitters(exc_nts)

    setup_neuron = generate_setup_neuron(c_m=25.0, rng=rng)

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

    cue = ln.PoissonLattice(2, device=device)
    cue.populate(poisson, exc_n, exc_n)

    net = ln.IzhikevichNeuronNetwork.generate_network(
        [exc_lattice, inh_lattice], [cue])
    net.connect(0, 1, lambda x, y: True,
                lambda x, y: float(w_ie[y[0] % inh_n, y[1] % inh_n]))
    net.connect(1, 0, lambda x, y: rng.uniform() <= prob_exc_to_inh,
                lambda x, y: exc_to_inh)
    net.connect(2, 1, lambda x, y: x == y, lambda x, y: spike_train_to_exc)
    net.set_dt(dt)
    net.electrical_synapse = False
    net.chemical_synapse = True

    net.apply_spike_train_lattice_given_position(
        2, get_spike_train_setup_function(
            patterns, pattern_index, distortion, cue_firing_rate, exc_n,
            rng=rng))
    net.run_lattices(iterations)

    hist = np.stack(net.get_lattice(1).history)
    return hist.reshape(hist.shape[0], -1)       # (T, N)


def main(exc_n=7, inh_n=3, num_patterns=3, trials=3, iterations=800,
         filename="attractor_manifold_output.json", distortion=0.1,
         firing_data_filename=None, device="cuda"):
    rng = np.random.default_rng(0)
    num = exc_n * exc_n
    patterns = generate_patterns(num, 0.5, num_patterns, 10.0, rng=rng)
    w = get_weights(num, patterns, a=0.5, b=0.5, scalar=2.0 / num_patterns)
    w_ie = weights_ie(inh_n, 0.5, patterns, num_patterns)

    # state per trajectory: mean voltage trace per neuron over the
    # second half (settled attractor), one row per (pattern, trial).
    # firing_data mirrors the reference generation pipeline's JSON
    # (attractor_manifold_generation.py:270-293): per-trial spike counts
    # keyed "trial: T, pattern: P, distortion: D" — the input format of
    # experiments/attractor_manifold_plot.py.
    rows, labels = [], []
    firing_data = {}
    for p in range(num_patterns):
        for t in range(trials):
            traj = run_trial(w, w_ie, patterns, p, exc_n, inh_n, rng,
                             iterations=iterations, distortion=distortion,
                             device=device)
            rows.append(traj[iterations // 2:].mean(axis=0))
            labels.append(p)
            # reference semantics (attractor_manifold_generation.py:267):
            # voltage peaks above threshold 20 — a plain rising-edge count
            # at ~v_th misses chemical-drive spikes whose recorded peak
            # sits below the threshold
            settled = traj[iterations // 2:]
            spikes = [len(find_peaks_above_threshold(settled[:, i], 20))
                      for i in range(settled.shape[1])]
            firing_data[f"trial: {t}, pattern: {p}, "
                        f"distortion: {distortion}"] = {
                "firing_rates": [int(s) for s in spikes]}
    X = np.stack(rows)
    labels = np.array(labels)

    # PCA embedding of the attractor states
    Xc = X - X.mean(axis=0, keepdims=True)
    _, s, vt = np.linalg.svd(Xc, full_matrices=False)
    emb = Xc @ vt[:2].T                          # (n_traj, 2)

    centroids = np.stack([emb[labels == p].mean(axis=0)
                          for p in range(num_patterns)])
    within = float(np.mean([np.linalg.norm(emb[i] - centroids[labels[i]])
                            for i in range(len(labels))]))
    between = float(np.mean(
        [np.linalg.norm(centroids[i] - centroids[j])
         for i in range(num_patterns) for j in range(i + 1, num_patterns)]))

    print(f"attractor separation: within {within:.2f}, between {between:.2f} "
          f"({'OK' if between > within else 'WEAK'})")
    with open(output_path(filename), "w") as f:
        json.dump({"embedding": emb.tolist(), "labels": labels.tolist(),
                   "within": within, "between": between,
                   "explained_variance": (s[:2] ** 2 / (s ** 2).sum()).tolist(),
                   "patterns": [[int(x) for x in pat] for pat in patterns]},
                  f)
    if firing_data_filename is not None:
        firing_data["patterns"] = [[int(x) for x in pat]
                                   for pat in patterns]
        with open(output_path(firing_data_filename), "w") as f:
            json.dump(firing_data, f, indent=4)
    return within, between


def cli(argv=None):
    """The command line: `main` at its defaults on ``--device``."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    return main(device=a.device)


if __name__ == "__main__":
    cli()

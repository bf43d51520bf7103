"""Synaptic pruning and memory recall.

Port of the reference's
`interface/examples/schizophrenic_synaptic_pruning.py`:
a Hopfield pattern is stored in an excitatory lattice; synapses are randomly
pruned at decreasing connectivity levels (1.0 -> 0.2) and recall accuracy
under a distorted Poisson cue is measured — modeling the excessive synaptic
pruning hypothesis of schizophrenia.

PyTorch counterpart of ``examples/synaptic_pruning.py``, on the port's
`lixirnet` and on ``device`` (``"cuda"`` by default).

Run: python -m spiking_neural_networks_tpu_torch.examples.synaptic_pruning
[--device cpu]
"""

import numpy as np

from .. import lixirnet as ln
from ..analysis.peaks import find_peaks_above_threshold
from . import device_main

N = 7
NUM = N * N
ITERATIONS = 1500
PEAK_THRESHOLD = 20.0


def get_weights(n, patterns, scalar=1.0):
    w = np.zeros((n, n))
    for pattern in patterns:
        w += np.outer(pattern, pattern)
    np.fill_diagonal(w, 0)
    return w * scalar


def accuracy(true_pattern, firing_counts, threshold):
    pred = (firing_counts > threshold).astype(int)
    return float((pred == true_pattern).mean())


def run_trial(w, pattern, connectivity, distortion, rng, dt=0.5,
              device="cuda"):
    inh = ln.IzhikevichNeuronLattice(0, device=device)
    inh.populate(ln.IzhikevichNeuron(), 3, 3)
    inh.connect(lambda x, y: x != y, lambda x, y: -1.0)

    exc = ln.IzhikevichNeuronLattice(1, device=device)
    exc.populate(ln.IzhikevichNeuron(), N, N)
    exc.apply(lambda nr: setattr(
        nr, "current_voltage", float(rng.uniform(-65, 30))))
    pos_to_idx = exc.position_to_index
    keep = rng.uniform(size=(NUM, NUM)) < connectivity
    exc.connect(
        lambda x, y: bool(w[pos_to_idx[x]][pos_to_idx[y]] != 0
                          and keep[pos_to_idx[x]][pos_to_idx[y]]),
        lambda x, y: float(w[pos_to_idx[x]][pos_to_idx[y]]))
    exc.update_grid_history = True

    cue = ln.PoissonLattice(2, device=device)
    cue.populate(ln.PoissonNeuron(), N, N)

    net = ln.IzhikevichNeuronNetwork.generate_network([exc, inh], [cue])
    net.connect(0, 1, lambda x, y: True, lambda x, y: -2.0)
    net.connect(1, 0, lambda x, y: True, lambda x, y: 3.0)
    net.connect(2, 1, lambda x, y: x == y, lambda x, y: 5.0)
    net.set_dt(dt)

    def setup_cue(pos, neuron):
        on = pattern[pos[0] * N + pos[1]] == 1
        if rng.uniform() < distortion:
            on = not on
        neuron.chance_of_firing = 0.01 if on else 0.0

    net.apply_spike_train_lattice_given_position(2, setup_cue)
    net.run_lattices(ITERATIONS)

    hist = np.stack(net.get_lattice(1).history).reshape(ITERATIONS, NUM)
    counts = np.array([len(find_peaks_above_threshold(hist[:, i],
                                                      PEAK_THRESHOLD))
                       for i in range(NUM)])
    best = max(accuracy(pattern, counts, th)
               for th in range(0, max(int(counts.max()), 1) + 1))
    return best


def main(trials=3, device="cuda"):
    rng = np.random.default_rng(0)
    pattern = (rng.uniform(size=NUM) < 0.5).astype(int)
    w = get_weights(NUM, [2 * pattern - 1], scalar=1.0 / NUM)

    print("connectivity -> recall accuracy (mean over trials)")
    results = {}
    for connectivity in (1.0, 0.8, 0.6, 0.4, 0.2):
        accs = [run_trial(w, pattern, connectivity, 0.1, rng,
                          device=device)
                for _ in range(trials)]
        results[connectivity] = float(np.mean(accs))
        print(f"  {connectivity:.1f} -> {results[connectivity]:.3f}")
    degraded = results[0.2] <= results[1.0]
    print(f"pruning degrades recall: {degraded}")
    return results


def cli(argv=None):
    """The command line: `main` on ``--device``."""
    return device_main(main, argv)


if __name__ == "__main__":
    cli()

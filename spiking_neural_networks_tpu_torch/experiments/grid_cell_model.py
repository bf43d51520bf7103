"""Grid-cell toroidal attractor (electrical model), on the port's
`lixirnet`.

PyTorch counterpart of ``experiments/grid_cell_model.py``, the port of
the reference's `interface_gpu/experiments/grid_cell_electrical_model.py`:
a 2-D sheet of Izhikevich neurons with toroidal local-excitation /
global-inhibition weights forms a stable activity bump; setter cells
(rate spike trains with distance-scaled rates) pin the bump to a location.
The lattices run on the card (``device="cuda"``, the default) unless the
caller names another device.

Run: python -m spiking_neural_networks_tpu_torch.experiments.\
grid_cell_model [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import lixirnet as ln

N = 20


def toroidal_dist(a, b, n):
    dx = abs(a[0] - b[0])
    dy = abs(a[1] - b[1])
    if dx > n / 2:
        dx = n - dx
    if dy > n / 2:
        dy = n - dy
    return np.sqrt(dx ** 2 + dy ** 2)


def grid_weight(x, y):
    return 3 * np.exp(-2 * toroidal_dist(x, y, N) ** 2 / (N * 3)) - 0.9


def main(iterations=2000, target=(5, 12), device="cuda"):
    rng = np.random.default_rng(0)

    def setup_neuron(neuron):
        # quiet start: the setter drive, not the random init, seeds the bump
        neuron.current_voltage = neuron.c
        neuron.c_m = 25
        return neuron

    grid_cells = ln.IzhikevichNeuronLattice(0, device=device)
    grid_cells.populate(ln.IzhikevichNeuron(), N, N)
    grid_cells.connect(lambda x, y: True, grid_weight)
    grid_cells.apply(setup_neuron)
    grid_cells.update_grid_history = True

    setters = ln.RateSpikeTrainLattice(1, device=device)
    setters.populate(ln.RateSpikeTrain(), N, N)

    def setup_setter(pos, neuron):
        # RateSpikeTrain fires every `rate` ms: small rate = fast drive.
        # Cells near the target fire every step; cells beyond radius 3 are
        # silent (rate = 0 disables the train, spike_train/mod.rs:1018).
        d = toroidal_dist(pos, target, N)
        neuron.rate = 1.0 if d <= 3 else 0.0

    setters.apply_given_position(setup_setter)

    net = ln.IzhikevichNeuronNetwork.generate_network([grid_cells], [setters])
    # input averaging divides by the total in-degree (N*N intra edges + 1),
    # so the one-to-one setter weight must counteract the dilution
    net.connect(1, 0, lambda x, y: x == y, lambda x, y: float(N * N) * 2.0)
    net.set_dt(1.0)
    net.run_lattices(iterations)

    hist = np.stack(grid_cells.history)
    counts = (hist[iterations // 2:] >= 29.0).sum(axis=0).astype(np.float64)
    # circular center of mass on the torus
    center = []
    for axis in range(2):
        profile = counts.sum(axis=1 - axis)
        ang = 2 * np.pi * np.arange(N) / N
        z = (profile * np.exp(1j * ang)).sum()
        center.append((np.angle(z) % (2 * np.pi)) / (2 * np.pi) * N)
    center = tuple(round(c, 1) for c in center)
    d = toroidal_dist(center, target, N)
    print(f"activity bump centered at {center}, target {target}, "
          f"toroidal distance {d:.1f} ({'OK' if d <= 4 else 'OFF'})")
    return center, d


def cli(argv=None):
    """The command line: `main` at its defaults on ``--device``."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    return main(device=a.device)


if __name__ == "__main__":
    cli()

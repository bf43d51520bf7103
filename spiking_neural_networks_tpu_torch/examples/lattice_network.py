"""Two coupled lattices + a Poisson input lattice (the reference's
`backend/examples/lattice_network/main.rs` doc-test scenario,
neuron/mod.rs:1464-1536).  PyTorch counterpart of
``examples/lattice_network.py``, on ``device`` (``"cuda"`` by default).

Run: python -m spiking_neural_networks_tpu_torch.examples.lattice_network
[--device cpu]"""

import numpy as np

import spiking_neural_networks_tpu_torch as snn
from . import device_main


def one_to_one(x, y):
    return x == y


def close_connect(x, y):
    return abs(x[0] - y[0]) < 2 and abs(x[1] - y[1]) <= 2


def weight_function(x, y):
    return ((x[0] - y[0]) ** 2 + (x[1] - y[1]) ** 2) ** 0.5


def main(device="cuda"):
    lattice1 = snn.Lattice(snn.Izhikevich(), id=0, device=device)
    lattice1.populate(3, 3, gap_conductance=10.0)
    lattice2 = snn.Lattice(snn.Izhikevich(), id=1, device=device)
    lattice2.populate(3, 3, gap_conductance=10.0)

    st = snn.SpikeTrainLattice(snn.PoissonSpikeTrain(), id=2, device=device)
    st.populate(3, 3, chance_of_firing=0.01)

    network = snn.LatticeNetwork.generate_network([lattice1, lattice2], [st])
    network.connect(0, 1, one_to_one, weight_function)
    network.connect(1, 0, one_to_one, weight_function)
    network.connect(2, 0, close_connect)
    network.get_lattice(0).update_grid_history = True

    network.run_lattices(500)
    hist = np.stack(network.get_lattice(0).grid_history.history)
    print(f"network ran 500 steps; lattice 0 V in "
          f"[{hist.min():.1f}, {hist.max():.1f}]")


def cli(argv=None):
    """The command line: `main` on ``--device``."""
    return device_main(main, argv)


if __name__ == "__main__":
    cli()

"""Izhikevich lattice with radius-2 random connectivity (the reference's
`backend/examples/lattice/main.rs`): run 5000 steps, save the voltage
history.  PyTorch counterpart of ``examples/lattice.py``, on ``device``
(``"cuda"`` by default).

Run: python -m spiking_neural_networks_tpu_torch.examples.lattice
[--device cpu]"""

import numpy as np
import torch

import spiking_neural_networks_tpu_torch as snn
from ..experiments.pipeline_setup import output_path
from . import device_main


def main(device="cuda"):
    rows, cols, iterations = 10, 10, 5000
    lat = snn.Lattice(snn.Izhikevich(), device=device)
    lat.populate(rows, cols, gap_conductance=10.0)
    # connect neurons within a radius of 2 with an 80% chance of connection
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=0)
    rng = np.random.default_rng(0)
    lat.apply(lambda s: {**s, "v": torch.as_tensor(
        rng.uniform(-65.0, 30.0, rows * cols), dtype=torch.float32,
        device=lat.device)})
    lat.update_grid_history = True

    lat.run_lattice(iterations)

    hist = np.stack(lat.grid_history.history)
    np.save(output_path("lattice_history.npy"), hist)
    print(f"saved lattice_history.npy {hist.shape}; "
          f"V in [{hist.min():.1f}, {hist.max():.1f}]")


def cli(argv=None):
    """The command line: `main` on ``--device``."""
    return device_main(main, argv)


if __name__ == "__main__":
    cli()

"""EEG readout + power spectral density of an inhibition-stabilized lattice
(the reference's interface/examples/inh_exc.py + eeg analysis).  PyTorch
counterpart of ``examples/eeg_psd.py``, on ``device`` (``"cuda"`` by
default).

Run: python -m spiking_neural_networks_tpu_torch.examples.eeg_psd
[--device cpu]"""

import numpy as np
import torch

import spiking_neural_networks_tpu_torch as snn
from ..core.history import EEGHistory
from ..analysis import eeg
from . import device_main


def main(device="cuda"):
    lat = snn.Lattice(snn.Izhikevich(), device=device)
    lat.populate(10, 10, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=3)
    rng = np.random.default_rng(1)
    lat.apply(lambda s: {**s, "v": torch.as_tensor(
        rng.uniform(-65, 30, 100), dtype=torch.float32, device=lat.device)})
    lat.grid_history = EEGHistory()
    lat.update_grid_history = True

    iterations, dt = 10000, 0.1
    lat.run_lattice(iterations)

    series = np.asarray(lat.grid_history.history)
    faxis, sxx = eeg.get_power_density(series, dt, iterations * dt)
    dom = float(faxis[int(np.argmax(np.asarray(sxx)))])
    print(f"EEG series length {len(series)}; dominant frequency "
          f"{dom:.2f} (1/ms units)")


def cli(argv=None):
    """The command line: `main` on ``--device``."""
    return device_main(main, argv)


if __name__ == "__main__":
    cli()

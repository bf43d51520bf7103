"""Spike raster from a lattice run.

Port of the reference's `interface/examples/raster.py`: random local
connectivity (radius 2, 80%), randomized initial voltages, long run, then a
per-neuron spike raster extracted with peak detection.  Prints an ASCII
raster instead of a matplotlib figure.

PyTorch counterpart of ``examples/raster.py``, on the port's `lixirnet`
and on ``device`` (``"cuda"`` by default).

Run: python -m spiking_neural_networks_tpu_torch.examples.raster
[--device cpu]
"""

import numpy as np

from .. import lixirnet as ln
from ..analysis.peaks import find_peaks_above_threshold
from . import device_main

N = 5
ITERATIONS = 2000
PEAK_THRESHOLD = 20.0


def main(device="cuda"):
    rng = np.random.default_rng(0)

    lattice = ln.IzhikevichNeuronLattice(0, device=device)
    lattice.populate(ln.IzhikevichNeuron(), N, N)
    lattice.apply(lambda n: setattr(
        n, "current_voltage", float(rng.uniform(-65, 30))))
    lattice.connect(
        lambda x, y: bool(
            np.hypot(x[0] - y[0], x[1] - y[1]) <= 2
            and rng.uniform() <= 0.8 and x != y))
    lattice.update_grid_history = True
    lattice.reset_timing()
    lattice.reset_history()
    lattice.run_lattice(ITERATIONS)

    hist = np.stack(lattice.history).reshape(ITERATIONS, N * N)
    raster = [find_peaks_above_threshold(hist[:, i], PEAK_THRESHOLD)
              for i in range(N * N)]

    bins = 80
    width = ITERATIONS // bins
    print(f"spike raster ({N * N} neurons x {ITERATIONS} steps, "
          f"one column = {width} steps):")
    for i, peaks in enumerate(raster):
        row = [" "] * bins
        for p in peaks:
            row[min(p // width, bins - 1)] = "|"
        print(f"{i:3d} {''.join(row)}")
    rates = [len(p) / (ITERATIONS / 1000) for p in raster]
    print(f"mean firing rate: {np.mean(rates):.1f} spikes/1000 steps")


def cli(argv=None):
    """The command line: `main` on ``--device``."""
    return device_main(main, argv)


if __name__ == "__main__":
    cli()

"""Hodgkin-Huxley static-input sweep (the reference's
`backend/examples/hodgkin_huxley/main.rs`): gating variables + voltage.
PyTorch counterpart of ``examples/hodgkin_huxley.py``, on ``device``
(``"cuda"`` by default): the JAX script's scan over the model's step is a
loop of steps on the device, its traces stacked once at the end.

Run: python -m spiking_neural_networks_tpu_torch.examples.hodgkin_huxley
[--device cpu]"""

import numpy as np
import torch

import spiking_neural_networks_tpu_torch as snn
from . import device_main


def main(device="cuda"):
    model = snn.HodgkinHuxley()
    inputs = torch.tensor([0.0, 10.0, 25.0, 50.0], device=device)
    state = model.init_state(4, device=device)

    def step(s):
        s, spikes = model.step(s, inputs)
        return s, (s["v"], s["na$m_state"], s["k$n_state"])

    ys = []
    for _ in range(5000):
        state, y = step(state)
        ys.append(y)
    v, m, n_gate = (torch.stack(y).cpu().numpy() for y in zip(*ys))
    print("input ->  spikes (peak count over 50ms):")
    for col, i in enumerate(inputs):
        peaks = int(((v[1:-1, col] > 0) & (np.diff(v[:-1, col]) > 0)
                     & (np.diff(v[1:, col]) < 0)).sum())
        print(f"  {float(i):5.1f} -> {peaks}")
    return v


def cli(argv=None):
    """The command line: `main` on ``--device``."""
    return device_main(main, argv)


if __name__ == "__main__":
    cli()

"""Reward-modulated STDP lattice (the reference's
`backend/examples/rstdp_lattice/main.rs`): reward schedule shapes weights
through dopamine-modulated eligibility traces.  PyTorch counterpart of
``examples/rstdp_lattice.py``, on ``device`` (``"cuda"`` by default).

Run: python -m spiking_neural_networks_tpu_torch.examples.rstdp_lattice
[--device cpu]"""

import numpy as np
import torch

import spiking_neural_networks_tpu_torch as snn
from . import device_main


def main(device="cuda"):
    lat = snn.RewardModulatedLattice(snn.Izhikevich(), device=device)
    lat.populate(4, 4, gap_conductance=10.0)
    lat.connect(lambda x, y: x != y, lambda x, y: 1.0)
    rng = np.random.default_rng(0)
    lat.apply(lambda s: {**s, "v": torch.as_tensor(
        rng.uniform(-65, 30, 16), dtype=torch.float32, device=lat.device)})

    rewards = np.where(np.arange(1000) % 100 < 50, 1.0, -0.5)
    # the schedule stays on the host: the runner reads it per call
    lat.run_lattice_with_reward(rewards.astype(np.float32), 1000)

    w = lat.graph.weights.cpu().numpy()
    print(f"dopamine={lat.dopamine:.3f}; weights in "
          f"[{w.min():.2f}, {w.max():.2f}]; "
          f"trace |c| max={lat.trace['c'].abs().max().item():.4f}")


def cli(argv=None):
    """The command line: `main` on ``--device``."""
    return device_main(main, argv)


if __name__ == "__main__":
    cli()

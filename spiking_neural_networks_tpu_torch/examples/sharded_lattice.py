"""Shard one large Izhikevich lattice across every available device.

PyTorch counterpart of ``examples/sharded_lattice.py``.  The sharding is
data placement (parallel/lattice_sharding.py): the (rows, cols) state and
the stencil weight planes are split into row blocks with ghost rows, one
block per device of the mesh (every CUDA device there is, or the one CPU
with ``--device cpu``), and each block steps its rows.  The script prints
whether the result is bit-identical to the single-device run: this STDP
lattice runs the fused STDP kernel alone on one card and the plain step
per block sharded, two summation orders, so on the card it may print
False.

Run: python -m spiking_neural_networks_tpu_torch.examples.sharded_lattice
[--device cpu]
"""

import numpy as np
import torch

import spiking_neural_networks_tpu_torch as snn
from ..parallel import make_lattice_mesh, shard_lattice
from . import device_main


def build(rows=256, cols=256, device="cuda"):
    lat = snn.Lattice(snn.Izhikevich(), device=device)
    lat.populate(rows, cols, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=7)
    lat.do_plasticity = True
    v0 = np.random.default_rng(0).uniform(-65.0, 30.0, rows * cols)
    lat.state["v"] = torch.as_tensor(v0, dtype=torch.float32,
                                     device=lat.device)
    return lat


def main(device="cuda"):
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())] \
        if device == "cuda" else [torch.device(device)]
    print(f"{len(devices)} device(s): {devices[0].type}")

    single = build(device=device)
    single.run_lattice(500)
    v_single = single.state["v"].cpu().numpy()

    mesh = make_lattice_mesh(devices=devices)
    lat = build(device=device)
    shard_lattice(lat, mesh)
    lat.run_lattice(500)
    v_sharded = lat.state["v"].cpu().numpy()

    fired = int((lat.state["last_firing_time"] >= 0).sum())
    print(f"mesh {mesh.devices.shape}: {fired} neurons fired; "
          f"bit-exact vs single device: {np.array_equal(v_single, v_sharded)}")
    print("state sharding:", lat.blocks)


def cli(argv=None):
    """The command line: `main` on ``--device``."""
    return device_main(main, argv)


if __name__ == "__main__":
    cli()

"""Pipeline-parallel chain network: one lattice per device.

PyTorch counterpart of ``examples/pipelined_network.py``.  A 4-stage
Izhikevich chain (stage k drives stage k+1 through one-to-one gap
junctions) runs over a ("pp",) mesh: each device holds a full stage
(state + intra-lattice stencil graph) and the previous stage's membrane
voltages arrive every step.  Because stage k+1 at step t only needs stage
k at step t-1 (the two-phase network semantics), the pipeline has no
bubbles — all stages compute every step.  The mesh takes as many stages as
there are devices (every CUDA device, or the one CPU with ``--device
cpu``), at most 4.

Run: python -m spiking_neural_networks_tpu_torch.examples.pipelined_network
[--device cpu]
"""

import numpy as np
import torch

import spiking_neural_networks_tpu_torch as snn
from ..parallel import make_pipeline_mesh
from . import device_main


def build_chain(stages=4, rows=32, cols=32, device="cuda"):
    rng = np.random.default_rng(0)
    lats = []
    for k in range(stages):
        lat = snn.Lattice(snn.Izhikevich(), id=k, device=device)
        lat.populate(rows, cols, gap_conductance=10.0)
        lat.connect_stencil(radius=1.5, keep_prob=0.9, seed=k)
        v0 = rng.uniform(-65.0, 30.0, rows * cols)
        v0[rng.permutation(rows * cols)[: rows]] = 40.0   # kick stage input
        lat.state["v"] = torch.as_tensor(v0, dtype=torch.float32,
                                         device=lat.device)
        lat.do_plasticity = True
        lats.append(lat)
    net = snn.LatticeNetwork.generate_network(lats, [])
    for k in range(stages - 1):
        net.connect(k, k + 1, lambda a, b: a == b, lambda a, b: 3.0)
    return net


def main(device="cuda"):
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())] \
        if device == "cuda" else [torch.device(device)]
    stages = min(4, len(devices))
    net = build_chain(stages=stages, device=device)
    mesh = make_pipeline_mesh(stages, devices=devices)
    print(f"pipeline mesh {mesh.devices.shape} on {devices[0].type}")

    net.run_lattices_pipelined(1000, mesh=mesh)

    for k in range(stages):
        lat = net.get_lattice(k)
        fired = int((lat.state["last_firing_time"] >= 0).sum())
        vbar = float(lat.state["v"].mean())
        print(f"stage {k}: {fired:4d} neurons fired, mean V {vbar:7.2f} mV")


def cli(argv=None):
    """The command line: `main` on ``--device``."""
    return device_main(main, argv)


if __name__ == "__main__":
    cli()

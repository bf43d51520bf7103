"""BCM plasticity trajectory (the reference's
`backend/examples/bcm/main.rs`): two BCM-activity-tracking Poisson spike
trains (chances of firing 0.0025 and 0.00125) drive a single postsynaptic
`BCMIzhikevich` neuron (c_m=50, gap_conductance=5) through Gaussian-drawn
weights (mean 1.5, std 0.1, clipped to [1, 2]); the BCM rule updates the
input weights over 10k steps.  The reference writes pre/post voltage
columns to `voltages.csv` and the connecting-graph weight history to
`weights.txt`; here both histories are collected the same way
(`update_grid_history` on both lattices + `update_connecting_graph_history`)
and summarized (pass ``csv_path``/``weights_path`` to write the files).
PyTorch counterpart of ``examples/bcm.py``, on ``device`` (``"cuda"`` by
default).

Run: python -m spiking_neural_networks_tpu_torch.examples.bcm
[--device cpu]"""

import numpy as np
import torch

import spiking_neural_networks_tpu_torch as snn
from . import device_main


def main(iterations=10000, csv_path=None, weights_path=None, seed=0,
         device="cuda"):
    firing_rates = [0.0025, 0.00125]
    rng = np.random.default_rng(seed)

    st = snn.SpikeTrainLattice(snn.BCMPoissonSpikeTrain(), id=0,
                               device=device)
    st.populate(len(firing_rates), 1)
    st.apply(lambda s: {**s, "chance_of_firing": torch.as_tensor(
        firing_rates, dtype=torch.float32, device=st.device)})
    st.update_grid_history = True

    post = snn.Lattice(snn.BCMIzhikevich(), id=1, device=device)
    post.populate(1, 1, c_m=50.0, gap_conductance=5.0)
    post.plasticity = snn.BCM()
    post.do_plasticity = True
    post.update_grid_history = True

    net = snn.LatticeNetwork.generate_network([post], [st])
    w0 = np.clip(rng.normal(1.5, 0.1, (len(firing_rates), 1)), 1.0, 2.0)
    net.connect(0, 1, lambda x, y: True,
                lambda x, y: float(w0[x[0], 0]))
    net.update_connecting_graph_history = True
    net.run_lattices(iterations)

    post_v = np.asarray(net.get_lattice(1).grid_history.history)[:, 0, 0]
    pre_v = np.asarray(net.get_spike_train_lattice(0).grid_history.history)
    weights = np.asarray(net.connecting_graph_history)
    print(f"postsynaptic voltage: {len(post_v)} steps, range "
          f"[{post_v.min():.2f}, {post_v.max():.2f}] mV")
    for i in range(len(firing_rates)):
        spikes = int((pre_v[:, i, 0] >= 29.0).sum())
        print(f"presynaptic train {i} (p={firing_rates[i]}): "
              f"{spikes} spikes")
    final = weights[-1].reshape(-1)[:len(firing_rates)]
    print(f"BCM weights: start {w0.reshape(-1).round(3).tolist()} -> "
          f"final {[round(float(x), 3) for x in final]}")

    if csv_path is not None:
        cols = [pre_v[:, i, 0] for i in range(len(firing_rates))] + [post_v]
        names = [f"presynaptic_voltage_{i}" for i in range(len(firing_rates))]
        names.append("postsynaptic_voltage")
        with open(csv_path, "w") as f:
            f.write(",".join(names) + "\n")
            for row in zip(*cols):
                f.write(",".join(str(x) for x in row) + "\n")
    if weights_path is not None:
        with open(weights_path, "w") as f:
            for mat in weights:
                for row in np.atleast_2d(mat):
                    f.write(",".join(str(x) for x in row) + ",\n")
                f.write("-----\n")
    return weights


def cli(argv=None):
    """The command line: `main` on ``--device``."""
    return device_main(main, argv)


if __name__ == "__main__":
    cli()

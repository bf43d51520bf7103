"""STDP-coupled lattice driven by Poisson input (the reference's
`backend/examples/stdp/main.rs`): weight trajectories under plasticity.
PyTorch counterpart of ``examples/stdp.py``, on ``device`` (``"cuda"`` by
default).

Run: python -m spiking_neural_networks_tpu_torch.examples.stdp
[--device cpu]"""

import spiking_neural_networks_tpu_torch as snn
from . import device_main


def main(device="cuda"):
    lat = snn.Lattice(snn.Izhikevich(), id=0, device=device)
    lat.populate(5, 5, gap_conductance=10.0)
    lat.connect_stencil(radius=1.5, seed=1)
    lat.do_plasticity = True
    lat.plasticity = snn.STDP()
    lat.update_graph_history = True

    st = snn.SpikeTrainLattice(snn.PoissonSpikeTrain(), id=1, device=device)
    st.populate(5, 5)
    st.state = st.model.init_from_firing_rate(25, hertz=50.0, dt=0.1,
                                              device=st.device)

    net = snn.LatticeNetwork.generate_network([lat], [st])
    net.connect(1, 0, lambda x, y: x == y, lambda x, y: 3.0)
    net.run_lattices(2000)

    w = net.get_lattice(0).graph.weights
    src, dst, wc = net.connections[(1, 0)]
    print(f"intra weights now in [{w.min():.2f}, {w.max():.2f}]; "
          f"input weights in [{wc.min():.2f}, {wc.max():.2f}]")


def cli(argv=None):
    """The command line: `main` on ``--device``."""
    return device_main(main, argv)


if __name__ == "__main__":
    cli()

"""Hopfield autoassociative recall (the reference's
`backend/examples/hopfield/main.rs` and attractors doc-test).  PyTorch
counterpart of ``examples/hopfield.py``: the discrete lattice's state on
``device`` (``"cuda"`` by default).

Run: python -m spiking_neural_networks_tpu_torch.examples.hopfield
[--device cpu]"""

from .. import attractors
from . import device_main


def main(device="cuda"):
    patterns = attractors.generate_random_patterns(10, 10, 3, 0.5, seed=4)
    weights = attractors.generate_hopfield_network(patterns)
    lattice = attractors.DiscreteNeuronLattice(10, 10, weights,
                                               device=device)

    for n, pattern in enumerate(patterns):
        distorted = attractors.distort_pattern(pattern, 0.2, seed=5 + n)
        lattice.input_pattern_into_discrete_grid(distorted)
        lattice.iterate(10)
        recovered = (lattice.convert_to_bools() == pattern).all()
        print(f"pattern {n}: recovered={bool(recovered)}")


def cli(argv=None):
    """The command line: `main` on ``--device``."""
    return device_main(main, argv)


if __name__ == "__main__":
    cli()

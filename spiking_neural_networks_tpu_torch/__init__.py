"""spiking_neural_networks_tpu_torch — the PyTorch/CUDA port.

A second package beside ``spiking_neural_networks_tpu`` (JAX), with the same
module layout, public names and flat per-neuron state dict.  This slice
holds the electrical Izhikevich lattice on a stencil graph: the Izhikevich
model, stencil graphs, the lattice runtime and its history readouts, and
one hand-written CUDA kernel for NVIDIA Hopper (``csrc/``) that runs the
lattice's steps on the GPU.  It imports PyTorch and NumPy, never JAX.
"""

__version__ = "0.1.0"

from .models.integrate_and_fire import Izhikevich
from .core.lattice import Lattice
from . import errors
from .core.plasticity import STDP
from .core import history
from .ops.graph import SparseGraph, StencilGraph, radius_offsets

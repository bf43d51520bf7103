"""spiking_neural_networks_tpu_torch — the PyTorch/CUDA port.

A second package beside ``spiking_neural_networks_tpu`` (JAX), with the same
module layout, public names and flat per-neuron state dict.  It holds the
electrical lattice on a stencil graph (the integrate-and-fire family:
leaky, quadratic, adaptive leaky, adaptive exponential, simple leaky,
Izhikevich, leaky and BCM Izhikevich; `DopaIzhikevich`; Morris-Lecar),
the Hodgkin-Huxley lattice with chemical synapses (Ionotropic receptors),
the plain `Lattice` with STDP or BCM,
the reward-modulated (R-STDP) lattice, spike trains, the plain
`LatticeNetwork` of lattices and trains (electrical and chemical, on
stencil, dense and sparse graphs with one-to-one, resample and dense
connections; structured or flat COO runner) and the
`RewardModulatedLatticeNetwork`, with their history readouts, the
closed agent-environment loops (`Environment`, `UnsupervisedEnvironment`,
`interactable.JitEnvironment`), the `.nb` model-definition language
(`dsl`: `dsl.neuron_builder` compiles neurons, spike trains, ion channels,
receptors and kinetics into the package's classes), and hand-written CUDA
kernels for NVIDIA Hopper (``csrc/``) that run those lattices' and
networks' steps on the GPU.  A DSL neuron on an electrical stencil lattice
runs on the model kernel, through a CUDA functor generated from its step
and built by nvcc at first use (``ops/dsl_kernels.py``; sin, cos and tan
included).  ``lixirnet`` is the reference's Python surface (its prototype
neurons, lattices and networks, the legacy v0.1 families), over these
lattices and networks on the card; ``experiments`` holds the science
pipelines written against it and the core (the Bayesian-inference trial:
``python -m spiking_neural_networks_tpu_torch.experiments.\
bayesian_inference_rate_based``; the liquids, the digit pipelines over
the repository's copy of the 8x8 digits, the attractors, grid cells and
head-direction rings), and ``examples`` the 16 examples (``python -m
spiking_neural_networks_tpu_torch.examples.<name> [--device cpu]``).  ``analysis`` (peaks, correlation, EEG
spectra), ``attractors`` (Hopfield weights, the discrete lattice),
``coupling`` (gap-junction and coupled-neuron steps) and
``utils.distribution`` are the support modules; ``fitting`` fits a neuron
model's parameters to another's spiking by a genetic algorithm,
``utils.checkpoint`` saves and resumes lattices and networks in the JAX
package's file format, ``utils.profiling`` times steps and writes profiler
traces, ``why_not_fused`` says why a lattice misses its kernel route, and
``_native`` builds graphs in host C++ (g++ at its first import), and
``parallel`` shards one lattice over a mesh of devices in row blocks (the
stencil kernel per block), runs chains of lattices as pipelines, one
stage per device, batched lattices over a (dp, tp) mesh, and meshes
across processes.  Every module and entry point of the JAX package is
ported.  Entry points put their tensors on the GPU
(``device="cuda"``) unless the caller asks for another device.  It
imports PyTorch and NumPy, never JAX.
"""

__version__ = "0.9.0"

from .models.integrate_and_fire import (
    AdaptiveExpLeakyIntegrateAndFire, AdaptiveLeakyIntegrateAndFire,
    BCMIzhikevich, Izhikevich, LeakyIntegrateAndFire, LeakyIzhikevich,
    QuadraticIntegrateAndFire, SimpleLeakyIntegrateAndFire)
from .models.dopa import DopaIzhikevich
from .models.hodgkin_huxley import HodgkinHuxley
from .models.morris_lecar import MorrisLecar
from .models.spike_train import (
    BCMPoissonSpikeTrain, PoissonSpikeTrain, PresetSpikeTrain,
    RateSpikeTrain)
from .core.lattice import Lattice
from .core.network import LatticeNetwork, SpikeTrainLattice
from .core.reward import RewardModulatedLattice
from .core.reward_network import RewardModulatedLatticeNetwork
from . import dsl, errors
from .core.plasticity import BCM, STDP, RewardModulatedSTDP
from .core import history
from .ops.graph import (DenseGraph, SparseGraph, StencilGraph,
                        radius_offsets)
from .ops.receptors import DopaGluGABAReceptors, IonotropicReceptors
from .interactable import Environment, UnsupervisedEnvironment
from . import analysis, attractors, coupling
from . import fitting
from .diagnostics import why_not_fused
from . import parallel

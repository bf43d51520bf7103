"""Carrying states, graphs and whole lattices in from NumPy.

The JAX package's arrays become NumPy with ``np.asarray`` on each leaf;
these functions turn such arrays into the PyTorch package's tensors on a
device, keeping every dtype, so that both packages start from the same
numbers.  `lattice_from` and `reward_lattice_from` read any lattice object
with the JAX package's attribute names (``state``, ``graph``, ``trace``,
``dopamine``, ``internal_clock``, ...) through ``np.asarray`` alone.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.graph import StencilGraph


def _tensor(a, device):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def state_from_numpy(state, device):
    """A state dict of tensors on ``device`` from a dict of NumPy arrays."""
    return {k: _tensor(np.asarray(v), device) for k, v in state.items()}


def stencil_graph_from_numpy(offsets, weights, mask, in_deg, device):
    """A `StencilGraph` on ``device`` from its (n_off, rows, cols) weight
    and mask planes and its (rows, cols) in-degree."""
    return StencilGraph(tuple(map(tuple, offsets)),
                        _tensor(np.asarray(weights, np.float32), device),
                        _tensor(np.asarray(mask, bool), device),
                        _tensor(np.asarray(in_deg, np.float32), device))


def _carry(src, dst):
    """Copy the grid, its state and stencil graph, the flags and the clock
    of lattice ``src`` into the populated-to-be lattice ``dst``."""
    dst.rows, dst.cols = src.rows, src.cols
    dst.state = state_from_numpy(src.state, dst.device)
    g = src.graph
    dst.graph = stencil_graph_from_numpy(g.offsets, np.asarray(g.weights),
                                         np.asarray(g.mask),
                                         np.asarray(g.in_deg), dst.device)
    dst.electrical_synapse = bool(src.electrical_synapse)
    dst.chemical_synapse = bool(src.chemical_synapse)
    dst.internal_clock = int(src.internal_clock)
    return dst


def lattice_from(src, model, device="cpu"):
    """A port `Lattice` of ``model`` with the state, `StencilGraph`,
    plasticity switch and parameters, and clock of lattice ``src``."""
    from .core.lattice import Lattice
    lat = _carry(src, Lattice(model, id=src.id, device=device))
    lat.do_plasticity = bool(src.do_plasticity)
    lat.plasticity.params = {k: float(v)
                             for k, v in src.plasticity.params.items()}
    return lat


def reward_lattice_from(src, model, device="cpu"):
    """A port `RewardModulatedLattice` of ``model`` with the state,
    `StencilGraph`, trace dict (c and dw float32, counter int32),
    dopamine, R-STDP parameters, modulation switch and clock of the
    reward lattice ``src``."""
    from .core.reward import RewardModulatedLattice
    lat = _carry(src, RewardModulatedLattice(model, id=src.id,
                                             device=device))
    lat.trace = {k: _tensor(np.asarray(src.trace[k], dt), device)
                 for k, dt in (("c", np.float32), ("dw", np.float32),
                               ("counter", np.int32))}
    lat.dopamine = float(src.dopamine)
    lat.do_modulation = bool(src.do_modulation)
    lat.reward_modulator.params = {
        k: float(v) for k, v in src.reward_modulator.params.items()}
    return lat

"""Carrying states, graphs and whole lattices in from NumPy.

The JAX package's arrays become NumPy with ``np.asarray`` on each leaf;
these functions turn such arrays into the PyTorch package's tensors on a
device, keeping every dtype, so that both packages start from the same
numbers.  `lattice_from`, `reward_lattice_from`, `spike_train_lattice_from`,
`network_from` and `reward_network_from` read any object with the JAX
package's attribute names (``state``, ``graph``, ``trace``, ``dopamine``,
``internal_clock``, ``connections``, ``reward_connections``, ...) through
``np.asarray`` alone; `env_from` carries a closed loop's environment
tree.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import history
from .ops.graph import DenseGraph, SparseGraph, StencilGraph


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


def graph_from(g, device):
    """A port `StencilGraph`, `SparseGraph` or `DenseGraph` with the arrays
    of graph ``g`` (any object with the JAX package's attribute names; a
    dense graph has ``weights`` and ``mask`` of shape (n_pre, n_post) and
    neither ``offsets`` nor ``src``)."""
    if hasattr(g, "offsets"):
        return stencil_graph_from_numpy(g.offsets, np.asarray(g.weights),
                                        np.asarray(g.mask),
                                        np.asarray(g.in_deg), device)
    if hasattr(g, "src"):
        return SparseGraph(_tensor(np.asarray(g.src, np.int64), device),
                           _tensor(np.asarray(g.dst, np.int64), device),
                           _tensor(np.asarray(g.weights, np.float32), device),
                           g.n_pre, g.n_post,
                           _tensor(np.asarray(g.in_deg, np.float32), device))
    if hasattr(g, "weights") and hasattr(g, "mask") \
            and np.ndim(g.weights) == 2 \
            and np.shape(g.weights) == np.shape(g.mask):
        return DenseGraph(_tensor(np.asarray(g.weights, np.float32), device),
                          _tensor(np.asarray(g.mask, bool), device))
    raise TypeError(f"no port graph for {type(g).__name__}")


def env_from(tree, device="cuda"):
    """A `JitEnvironment` environment tree on ``device`` from the JAX
    package's (dicts, lists and tuples kept): every leaf, a NumPy or JAX
    scalar or array, becomes a float32 tensor of its shape (0-dim for a
    scalar)."""
    if isinstance(tree, dict):
        return {k: env_from(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(env_from(v, device) for v in tree)
    return _tensor(np.asarray(tree, np.float32), device)


def history_from(h):
    """A port history readout of the kind (and EEG parameters) of ``h``."""
    cls = history.HISTORY_KINDS[h.kind]
    if h.kind == "eeg":
        return cls(h.reference_voltage, h.distance, h.conductivity)
    return cls()


def _carry(src, dst):
    """Copy the grid, its state and graph, the flags and the clock of
    lattice ``src`` into the populated-to-be lattice ``dst``."""
    dst.rows, dst.cols = src.rows, src.cols
    dst.state = state_from_numpy(src.state, dst.device)
    dst.graph = graph_from(src.graph, dst.device)
    dst.electrical_synapse = bool(src.electrical_synapse)
    dst.chemical_synapse = bool(src.chemical_synapse)
    dst.internal_clock = int(src.internal_clock)
    return dst


def lattice_from(src, model=None, device="cuda"):
    """A port `Lattice` of ``model`` (by default the port's model of the
    class and kinetics of ``src.model``) with the state, graph, plasticity
    switch and parameters, and clock of lattice ``src``."""
    from .core.lattice import Lattice
    if model is None:
        model = _port_model(src.model)
    lat = _carry(src, Lattice(model, id=src.id, device=device))
    lat.do_plasticity = bool(src.do_plasticity)
    lat.plasticity = _port_rule(src.plasticity)
    return lat


def _port_rule(rule):
    """The port's plasticity rule (`STDP` or `BCM`) of the class and
    parameters of a JAX rule."""
    from .core import plasticity
    out = getattr(plasticity, type(rule).__name__)()
    out.params = {k: float(v) for k, v in rule.params.items()}
    return out


def reward_lattice_from(src, model, device="cuda"):
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


def spike_train_lattice_from(src, model, device="cuda"):
    """A port `SpikeTrainLattice` of ``model`` with the state, history
    switch and clock of spike-train lattice ``src``."""
    from .core.network import SpikeTrainLattice
    st = SpikeTrainLattice(model, id=src.id, device=device)
    st.rows, st.cols = src.rows, src.cols
    st.state = state_from_numpy(src.state, st.device)
    st.internal_clock = int(src.internal_clock)
    st.update_grid_history = bool(src.update_grid_history)
    st.grid_history = history_from(src.grid_history)
    return st


def _port_model(model):
    """The port's model of the class and configuration of a JAX model: its
    kinetics and its receptor system (family and kinetics).  Raises a
    `ValueError` for a class the port does not ship, such as a neuron of
    the DSL: the caller passes the port's model (``model=``), built from
    the same source."""
    from .models import (dopa, hodgkin_huxley, integrate_and_fire,
                         morris_lecar, spike_train)
    from .ops import receptors
    name = type(model).__name__
    modules = (spike_train,) if hasattr(model, "refractoriness") else (
        hodgkin_huxley, dopa, integrate_and_fire, morris_lecar)
    module = next((m for m in modules if isinstance(getattr(m, name, None),
                                                    type)), None)
    if module is None or ".dsl." in type(model).__module__:
        raise ValueError(
            f"the port has no model class {name!r} (a DSL neuron or a user "
            f"class): pass the port's model with model=, e.g. "
            f"lattice_from(src, model=dsl.neuron_builder(source)[{name!r}]())")
    if module is spike_train:
        return getattr(spike_train, name)(model.nt_kinetics,
                                          model.refractoriness)
    rec = model.receptors
    kw = dict(nt_kinetics=model.nt_kinetics, rec_kinetics=model.rec_kinetics,
              receptors=getattr(receptors, type(rec).__name__)(rec.kinetics))
    if hasattr(model, "chemical_normalization"):
        kw["chemical_normalization"] = bool(model.chemical_normalization)
    return getattr(module, name)(**kw)


def _histories(src, dst):
    dst.update_grid_history = bool(src.update_grid_history)
    dst.grid_history = history_from(src.grid_history)
    dst.update_graph_history = bool(src.update_graph_history)
    return dst


def network_from(src_net, device="cuda", net=None):
    """A port `LatticeNetwork` (or the empty network ``net``) carrying
    every lattice's and train's state, graph, plasticity and history
    switches, the host COO connections, the synapse flags, the runner
    choice and the clock of the JAX network ``src_net``."""
    from .core.network import LatticeNetwork
    if net is None:
        net = LatticeNetwork(device)
    for lat in src_net.lattices.values():
        net.add_lattice(_histories(
            lat, lattice_from(lat, _port_model(lat.model), device)))
    for st in src_net.spike_train_lattices.values():
        net.add_spike_train_lattice(
            spike_train_lattice_from(st, _port_model(st.model), device))
    net.connections = {
        key: (np.asarray(s, np.int64), np.asarray(d, np.int64),
              np.asarray(w, np.float32))
        for key, (s, d, w) in src_net.connections.items()}
    net.electrical_synapse = bool(src_net.electrical_synapse)
    net.chemical_synapse = bool(src_net.chemical_synapse)
    net.update_connecting_graph_history = bool(
        src_net.update_connecting_graph_history)
    net.structured = bool(src_net.structured)
    net.internal_clock = int(src_net.internal_clock)
    net.history_chunk = src_net.history_chunk
    return net


def reward_network_from(src_net, device="cuda"):
    """A port `RewardModulatedLatticeNetwork` carrying, beside what
    `network_from` carries, every reward lattice (graph, traces,
    ``do_modulation``, dopamine, R-STDP parameters, histories), the host
    (src, dst, w, c, dw, counter) reward connections, the network's
    dopamine and its modulator's parameters."""
    from .core.reward_network import RewardModulatedLatticeNetwork
    net = RewardModulatedLatticeNetwork(device)
    for lat in src_net.reward_modulated_lattices.values():
        net.add_reward_modulated_lattice(_histories(
            lat, reward_lattice_from(lat, _port_model(lat.model), device)))
    network_from(src_net, device, net)
    net.reward_connections = {
        key: (np.asarray(s, np.int64), np.asarray(d, np.int64),
              np.asarray(w, np.float32), np.asarray(c, np.float32),
              np.asarray(dw, np.float32), np.asarray(ct, np.int32))
        for key, (s, d, w, c, dw, ct) in src_net.reward_connections.items()}
    net.dopamine = float(src_net.dopamine)
    net.reward_modulator.params = {
        k: float(v) for k, v in src_net.reward_modulator.params.items()}
    return net

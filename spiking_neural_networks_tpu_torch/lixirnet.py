"""lixirnet-compatible Python API: the reference's Python surface.

PyTorch counterpart of ``spiking_neural_networks_tpu/lixirnet.py``, the
drop-in surface for the reference's PyO3 module (`lixirnet`: prototype
neuron / kinetics / receptor objects, `IzhikevichNeuronLattice`,
`RateSpikeTrainLattice`, `IzhikevichNeuronNetwork` with the same method
names: `populate`, `connect`, `apply`, `apply_given_position`,
`run_lattice(s)`, `get_neuron` / `set_neuron`, `history`, `weights`, ...),
the legacy v0.1 families (HH, LIF, Ionotropic Izhikevich, Destexhe, the
ion-channel and Dopa* classes) and the ``*GPU`` classes.

Prototype objects are host-side records; `populate` broadcasts one into
the lattice's per-neuron state on the host and moves it to the lattice's
device in one copy.  Lattices and networks run on ``device="cuda"`` unless
the caller passes another device to the lattice constructors; a network
takes its lattices' device and raises on a mix.  `apply` and
`apply_given_position` loop neuron views on the host, the O(N) Python cost
the reference pays, over one host copy of the lattice's per-neuron fields
(one device-to-host copy per call, one host-to-device copy of the fields
a callback changed); `get_neuron` reads its fields in one copy, and
`set_neuron` writes by indexing on the device.  Use ``import
spiking_neural_networks_tpu_torch.lixirnet as ln``.
"""

from __future__ import annotations

import copy
from enum import IntEnum

import numpy as np
import torch

from .errors import GraphError, LatticeNetworkError
from .models.dopa import DopaIzhikevich
from .models import spike_train as st_models
from .core.lattice import Lattice as _Lattice
from .core.network import SpikeTrainLattice as _STLattice, \
    LatticeNetwork as _Network, _graph_to_coo
from .core import plasticity as _plasticity
from .ops.graph import DenseGraph, SparseGraph


class DopaGluGABANeurotransmitterType(IntEnum):
    Glutamate = 0
    GABA = 1
    Dopamine = 2


class IonotropicNeurotransmitterType(IntEnum):
    AMPA = 0
    NMDA = 1
    GABA = 2


class BoundedNeurotransmitterKinetics:
    def __init__(self, t_max=1.0, clearance_constant=0.001, t=0.0):
        self.t_max = t_max
        self.clearance_constant = clearance_constant
        self.t = t


class BoundedReceptorKinetics:
    def __init__(self, r_max=1.0, r=0.0):
        self.r_max = r_max
        self.r = r


class GlutamateReceptor:
    def __init__(self, ampa_r=None, nmda_r=None, g_ampa=1.0, g_nmda=0.6,
                 e_ampa=0.0, e_nmda=0.0, mg=0.3):
        self.ampa_r = ampa_r or BoundedReceptorKinetics()
        self.nmda_r = nmda_r or BoundedReceptorKinetics()
        self.g_ampa = g_ampa
        self.g_nmda = g_nmda
        self.e_ampa = e_ampa
        self.e_nmda = e_nmda
        self.mg = mg
        self.current = 0.0


class GABAReceptor:
    def __init__(self, r=None, g=1.2, e=-80.0):
        self.r = r or BoundedReceptorKinetics()
        self.g = g
        self.e = e
        self.current = 0.0


class DopamineReceptor:
    def __init__(self, r_d1=None, r_d2=None, s_d1=0.0, s_d2=0.0,
                 d1_enabled=True, d2_enabled=True):
        self.r_d1 = r_d1 or BoundedReceptorKinetics()
        self.r_d2 = r_d2 or BoundedReceptorKinetics()
        self.s_d1 = s_d1
        self.s_d2 = s_d2
        # legacy gating flags (interface/src/lib.rs:344-386): the v0.1
        # DopamineReceptor enables the d1/d2 pathways explicitly; the v0.4
        # surface gates by zero gain, so both flags default True here and
        # a disabled pathway installs as gain 0
        self.d1_enabled = d1_enabled
        self.d2_enabled = d2_enabled


class DopaGluGABA:
    """Receptor-set prototype (`DopaGluGABA`, lixirnet/src/lib.rs:45-66)."""

    def __init__(self):
        self.receptors = {}
        self.inh_modifier = 1.0
        self.nmda_modifier = 1.0

    def insert(self, neurotransmitter_type, receptor):
        t = DopaGluGABANeurotransmitterType(neurotransmitter_type)
        expected = {0: GlutamateReceptor, 1: GABAReceptor, 2: DopamineReceptor}
        if not isinstance(receptor, expected[int(t)]):
            raise ValueError(
                f"receptor type mismatch for {t.name}: {type(receptor).__name__}")
        self.receptors[int(t)] = receptor


class STDP:
    def __init__(self, a_plus=2.0, a_minus=2.0, tau_plus=4.5, tau_minus=4.5,
                 dt=0.1):
        self.a_plus = a_plus
        self.a_minus = a_minus
        self.tau_plus = tau_plus
        self.tau_minus = tau_minus
        self.dt = dt

    def _native(self):
        return _plasticity.STDP(self.a_plus, self.a_minus, self.tau_plus,
                                self.tau_minus, self.dt)


class DeltaDiracRefractoriness:
    def __init__(self, k=10000.0):
        self.k = k

    def get_effect(self, timestep, last_firing_time, v_max, v_resting, dt):
        """`NeuralRefractoriness::get_effect` (spike_train/mod.rs:67-74)
        with the DeltaDirac Gaussian decay (:84-86)."""
        a = v_max - v_resting
        time_difference = float(timestep - last_firing_time)
        return float(a * np.exp((-1.0 / (self.k / dt))
                                * time_difference ** 2.0) + v_resting)


# ---------------------------------------------------------------------------
# Prototype neurons
# ---------------------------------------------------------------------------

_IZH_SCALARS = ("current_voltage", "u", "a", "b", "c", "d", "v_th", "tau_m",
                "c_m", "dt", "gap_conductance")
_IZH_KEYMAP = {"current_voltage": "v", "u": "w"}


class IzhikevichNeuron:
    """Prototype for the lixirnet DSL IzhikevichNeuron (lib.rs:68-79);
    DSL-injected defaults: current_voltage=0, gap_conductance=10."""

    def __init__(self, **kw):
        self.current_voltage = 0.0
        self.u = 30.0
        self.a = 0.02
        self.b = 0.2
        self.c = -55.0
        self.d = 8.0
        self.v_th = 30.0
        self.tau_m = 1.0
        self.c_m = 100.0
        self.dt = 0.1
        self.gap_conductance = 10.0
        self.is_spiking = False
        self.last_firing_time = None
        self.synaptic_neurotransmitters = {}
        self.receptors = DopaGluGABA()
        self._has_receptors = False
        for k, v in kw.items():
            setattr(self, k, v)

    def set_synaptic_neurotransmitters(self, mapping):
        self.synaptic_neurotransmitters = dict(mapping)

    def get_synaptic_neurotransmitters(self):
        return self.synaptic_neurotransmitters

    def set_receptors(self, receptors):
        self.receptors = receptors
        self._has_receptors = True

    def get_receptors(self):
        return self.receptors


class RateSpikeTrain:
    """Prototype for the rate spike train (spike_train/mod.rs:974-1033)."""

    def __init__(self, rate=0.0, **kw):
        self.rate = rate
        self.step = 0.0
        self.current_voltage = 0.0
        self.v_th = 30.0
        self.v_resting = 0.0
        self.dt = 0.1
        self.is_spiking = False
        self.last_firing_time = None
        self.synaptic_neurotransmitters = {}
        self.neural_refractoriness = DeltaDiracRefractoriness()
        for k, v in kw.items():
            setattr(self, k, v)

    def set_synaptic_neurotransmitters(self, mapping):
        self.synaptic_neurotransmitters = dict(mapping)

    def iterate(self):
        """`RateSpikeTrain::iterate` (spike_train/mod.rs:1016-1030):
        host-side single-neuron stepping (prototype convenience; lattice
        simulation runs on device)."""
        self.step += self.dt
        if self.rate != 0.0 and self.step >= self.rate:
            self.step = 0.0
            self.current_voltage = self.v_th
            self.is_spiking = True
        else:
            self.current_voltage = self.v_resting
            self.is_spiking = False
        return self.is_spiking


class PoissonNeuron(RateSpikeTrain):
    def __init__(self, chance_of_firing=0.0, **kw):
        super().__init__(**kw)
        self.chance_of_firing = chance_of_firing

    def iterate(self):
        """`PoissonNeuron::iterate` (spike_train/mod.rs:352-366):
        host-side single-neuron stepping for prototype experimentation."""
        import random
        if random.random() <= self.chance_of_firing:
            self.current_voltage = self.v_th
            self.is_spiking = True
        else:
            self.current_voltage = self.v_resting
            self.is_spiking = False
        return self.is_spiking


class GraphPosition:
    def __init__(self, id, pos):
        self.id = id
        self.pos = tuple(pos)

    def __eq__(self, other):
        return (isinstance(other, GraphPosition)
                and self.id == other.id and self.pos == other.pos)

    def __hash__(self):
        return hash((self.id, self.pos))

    def __repr__(self):
        return f"GraphPosition {{ id: {self.id}, pos: {self.pos} }}"


# ---------------------------------------------------------------------------
# State broadcasting
# ---------------------------------------------------------------------------


def _neuron_overrides(neuron):
    over = {}
    for attr in _IZH_SCALARS:
        over[_IZH_KEYMAP.get(attr, attr)] = float(getattr(neuron, attr))
    return over


def _pull_state(state, keys=None, ndim=None):
    """A host copy (NumPy arrays) of the fields ``keys`` of ``state`` (all
    fields of ``ndim`` dimensions where ``keys`` is None), in one
    device-to-host copy: the fields are laid end to end as bytes on their
    device, the widest types first, then copied once."""
    if keys is None:
        keys = [k for k, v in state.items() if ndim is None or v.ndim == ndim]
    keys = sorted(keys, key=lambda k: -state[k].element_size())
    if not keys:
        return {}
    flat = torch.cat([state[k].contiguous().reshape(-1).view(torch.uint8)
                      for k in keys]).cpu().numpy()
    out, at = {}, 0
    for k in keys:
        t = state[k]
        n = t.numel() * t.element_size()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out[k] = flat[at:at + n].view(dtype).reshape(tuple(t.shape)).copy()
        at += n
    return out


def _to_device(arrays, device):
    """Tensors on ``device`` of the host arrays ``arrays``, in one
    host-to-device copy (each field then its own storage)."""
    keys = sorted(arrays, key=lambda k: -np.asarray(arrays[k]).itemsize)
    if not keys:
        return {}
    host = {k: np.ascontiguousarray(arrays[k]) for k in keys}
    flat = torch.from_numpy(np.concatenate(
        [host[k].reshape(-1).view(np.uint8) for k in keys])).to(device)
    out, at = {}, 0
    for k in keys:
        h = host[k]
        dtype = torch.from_numpy(np.empty(0, h.dtype)).dtype
        out[k] = flat[at:at + h.nbytes].view(dtype).reshape(h.shape).clone()
        at += h.nbytes
    return {k: out[k] for k in arrays}


def _set_scalar(state, key, idx, value):
    """``state[key][idx] = value`` as an indexed write on a copy of the
    field, on its device (no host round trip)."""
    t = state[key].clone()
    t[idx] = value
    state[key] = t


def _populate(inner, num_rows, num_cols, install, **over):
    """`populate` of the wrapped lattice ``inner`` built on the host:
    the model's state with ``over``, ``install(model, host_state)`` editing
    it in place, then one copy to ``inner.device``; a lattice of neurons
    gets its empty graph, as the core `populate`."""
    if getattr(inner, "in_network", False) \
            and (num_rows, num_cols) != (inner.rows, inner.cols):
        raise ValueError("dimensions must match when lattice is in a "
                         "network")
    host = inner.model.init_state_host(num_rows * num_cols, **over)
    install(inner.model, host)
    inner.rows, inner.cols = num_rows, num_cols
    inner.state = _to_device(host, inner.device)
    if hasattr(inner, "graph"):
        inner.graph = SparseGraph.empty(inner.n, device=inner.device)


def _host_insert_nt(model, host, name, **params):
    """Host-side `Neurotransmitters::insert` (no device round trips;
    semantics of models.base.insert_neurotransmitter)."""
    k = model.type_index(name)
    host["nt$mask"][:, k] = True
    for p, v in params.items():
        host[f"nt${p}"][:, k] = v


def _host_insert_receptor(model, host, name, **params):
    """Host-side `Receptors::insert` (ops.receptors.ReceptorSystem.insert)."""
    k = model.receptors.type_names.index(name)
    host["rec$mask"][:, k] = True
    for p, v in params.items():
        key = f"rec${p}"
        if host[key].ndim == 2:
            host[key][:, k] = v
        else:
            host[key][:] = v


def _install_synapses_host(model, host, neuron):
    """Install the prototype's neurotransmitters/receptors into a HOST
    state dict in place (no device traffic)."""
    for t, kin in neuron.synaptic_neurotransmitters.items():
        name = DopaGluGABANeurotransmitterType(t).name
        _host_insert_nt(model, host, name, t_max=kin.t_max,
                        clearance_constant=kin.clearance_constant, t=kin.t)
    rec = neuron.receptors
    if isinstance(rec, DopaGluGABA):
        n = host["v"].shape[0]
        for t, r in rec.receptors.items():
            name = DopaGluGABANeurotransmitterType(t).name
            _host_insert_receptor(model, host, name)
            if isinstance(r, GlutamateReceptor):
                host["rec$g_ampa"] = np.full((n,), r.g_ampa, np.float32)
                host["rec$g_nmda"] = np.full((n,), r.g_nmda, np.float32)
                host["rec$e_ampa"] = np.full((n,), r.e_ampa, np.float32)
                host["rec$e_nmda"] = np.full((n,), r.e_nmda, np.float32)
                host["rec$mg"] = np.full((n,), r.mg, np.float32)
                host["rec$r_max"][:, 0] = r.ampa_r.r_max
                host["rec$r2$r_max"][:, 0] = r.nmda_r.r_max
            elif isinstance(r, GABAReceptor):
                host["rec$g_gaba"] = np.full((n,), r.g, np.float32)
                host["rec$e_gaba"] = np.full((n,), r.e, np.float32)
                host["rec$r_max"][:, 1] = r.r.r_max
            elif isinstance(r, DopamineReceptor):
                s_d1 = r.s_d1 if getattr(r, "d1_enabled", True) else 0.0
                s_d2 = r.s_d2 if getattr(r, "d2_enabled", True) else 0.0
                host["rec$s_d1"] = np.full((n,), s_d1, np.float32)
                host["rec$s_d2"] = np.full((n,), s_d2, np.float32)
                host["rec$r_max"][:, 2] = r.r_d1.r_max
                host["rec$r2$r_max"][:, 2] = r.r_d2.r_max


class _NeuronView:
    """Mutable per-neuron view into host copies of the SoA arrays, handed to
    `apply` callbacks exactly like the reference's `&mut neuron`.
    Attribute access is installed below (keymap-aware)."""

    def __init__(self, arrays, idx, keymap=None):
        object.__setattr__(self, "_arrays", arrays)
        object.__setattr__(self, "_idx", idx)
        object.__setattr__(self, "_keymap", keymap or _IZH_KEYMAP)


class _LatticeMixin:
    _KEYMAP = _IZH_KEYMAP

    def _apply_views(self, function, keymap, positions=False):
        """``function(view)`` (``function((row, col), view)`` with
        ``positions``) for every neuron in flat order, over one host copy
        of the per-neuron fields; the fields a call changed go back to the
        device in one copy."""
        inner = self._inner
        arrays = _pull_state(inner.state, ndim=1)
        before = {k: v.copy() for k, v in arrays.items()}
        cols = inner.cols
        for idx in range(inner.n):
            view = _NeuronView(arrays, idx, keymap)
            if positions:
                function((idx // cols, idx % cols), view)
            else:
                function(view)
        changed = {k: v for k, v in arrays.items()
                   if v.tobytes() != before[k].tobytes()}
        if changed:
            inner.state = dict(inner.state,
                               **_to_device(changed, inner.device))

    def apply(self, function):
        self._apply_views(function, self._KEYMAP)

    def apply_given_position(self, function):
        self._apply_views(function, self._KEYMAP, positions=True)

    @property
    def device(self):
        return self._inner.device

    @property
    def history(self):
        return [np.asarray(h) for h in self._inner.grid_history.history]

    @property
    def update_grid_history(self):
        return self._inner.update_grid_history

    @update_grid_history.setter
    def update_grid_history(self, value):
        self._inner.update_grid_history = value

    def reset_timing(self):
        self._inner.reset_timing()

    def reset_history(self):
        self._inner.grid_history.reset()
        if hasattr(self._inner, "graph_history"):
            self._inner.graph_history.clear()

    def set_dt(self, dt):
        self._inner.set_dt(dt)

    def get_weight(self, presynaptic, postsynaptic):
        """`get_weight` (lattices/mod.rs:114-121): 0.0 when unconnected,
        KeyError when a position is outside the lattice."""
        try:
            w = self._inner.lookup_weight(tuple(presynaptic),
                                          tuple(postsynaptic))
        except GraphError:
            raise KeyError(
                f"Weight at ({presynaptic}, {postsynaptic}) not found")
        return 0.0 if w is None else w

    def edit_weight(self, presynaptic, postsynaptic, weight):
        """`Graph::edit_weight`: set or (None) remove one synapse."""
        try:
            self._inner.edit_weight(tuple(presynaptic), tuple(postsynaptic),
                                    weight)
        except GraphError:
            raise KeyError(
                f"Weight at ({presynaptic}, {postsynaptic}) not found")

    def get_incoming_connections(self, position):
        try:
            return self._inner.get_incoming_connections(tuple(position))
        except GraphError:
            raise KeyError(f"Position {position} not found in lattice")

    def get_outgoing_connections(self, position):
        try:
            return self._inner.get_outgoing_connections(tuple(position))
        except GraphError:
            raise KeyError(f"Position {position} not found in lattice")

    def get_id(self):
        return self._inner.id

    def set_id(self, id):
        self._inner.id = id

    def get_every_node(self):
        """`Graph::get_every_node` (lattices/mod.rs:60-62)."""
        return {(r, c) for r in range(self._inner.rows)
                for c in range(self._inner.cols)}

    @property
    def update_graph_history(self):
        return getattr(self._inner, "update_graph_history", False)

    @update_graph_history.setter
    def update_graph_history(self, value):
        self._inner.update_graph_history = value

    def weights_history(self):
        """Per-step (N, N) weight matrices (lattices/mod.rs:234-248;
        None entries become 0)."""
        g = self._inner.graph
        n = self._inner.n
        out = []
        for w in self._inner.graph_history:
            snap = g.replace_weights(torch.as_tensor(
                np.asarray(w), device=g.weights.device)) \
                if hasattr(g, "replace_weights") else g
            src, dst, wv, _ = _graph_to_coo(snap)
            mat = np.zeros((n, n), np.float32)
            mat[np.asarray(src), np.asarray(dst)] = np.asarray(wv)
            out.append(mat)
        return out

    def get_position_to_index_for_weights(self):
        cols = self._inner.cols
        return {(r, c): r * cols + c
                for r in range((self._inner.rows)) for c in range(cols)}

    def __repr__(self):
        return (f"{type(self).__name__} {{ ({self._inner.rows}x"
                f"{self._inner.cols}), id: {self._inner.id}, "
                f"do_plasticity: {getattr(self._inner, 'do_plasticity', False)}, "
                f"update_grid_history: {self._inner.update_grid_history} }}")


class IzhikevichNeuronLattice(_LatticeMixin):
    """`IzhikevichNeuronLattice` (lixirnet/src/lattices/mod.rs impl_lattice)
    of `DopaIzhikevich` neurons on ``device``."""

    def __init__(self, id=0, device="cuda"):
        self._inner = _Lattice(DopaIzhikevich(), id=id, device=device)
        self._prototype = None

    @property
    def inner(self):
        return self._inner

    def populate(self, neuron, num_rows, num_cols):
        self._prototype = copy.deepcopy(neuron)
        _populate(self._inner, num_rows, num_cols,
                  lambda model, host: _install_synapses_host(model, host,
                                                             neuron),
                  **_neuron_overrides(neuron))

    def connect(self, connection_conditional, weight_logic=None):
        self._inner.connect(connection_conditional, weight_logic)

    def connect_stencil(self, **kw):
        self._inner.connect_stencil(**kw)

    def run_lattice(self, iterations):
        self._inner.run_lattice(iterations)

    def _check_pos(self, row, col):
        if not (0 <= row < self._inner.rows and 0 <= col < self._inner.cols):
            raise KeyError(f"position ({row}, {col}) not in lattice")

    def get_neuron(self, row, col):
        self._check_pos(row, col)
        idx = row * self._inner.cols + col
        n = copy.deepcopy(self._prototype) if self._prototype else IzhikevichNeuron()
        keys = [_IZH_KEYMAP.get(a, a) for a in _IZH_SCALARS]
        host = _pull_state(self._inner.state,
                           keys + ["last_firing_time", "is_spiking"])
        for attr in _IZH_SCALARS:
            key = _IZH_KEYMAP.get(attr, attr)
            setattr(n, attr, float(host[key][idx]))
        lft = int(host["last_firing_time"][idx])
        n.last_firing_time = None if lft < 0 else lft
        n.is_spiking = bool(host["is_spiking"][idx])
        return n

    def set_neuron(self, row, col, neuron):
        self._check_pos(row, col)
        idx = row * self._inner.cols + col
        state = dict(self._inner.state)
        for attr in _IZH_SCALARS:
            key = _IZH_KEYMAP.get(attr, attr)
            _set_scalar(state, key, idx, float(getattr(neuron, attr)))
        self._inner.state = state

    @property
    def weights(self):
        g = self._inner.graph
        if isinstance(g, DenseGraph):
            return torch.where(g.mask, g.weights, 0.0).cpu().numpy()
        # stencil/sparse backends: materialize the (N, N) matrix on host
        src, dst, w, _ = _graph_to_coo(g)
        n = self._inner.n
        out = np.zeros((n, n), np.float32)
        out[np.asarray(src), np.asarray(dst)] = np.asarray(w)
        return out

    @property
    def position_to_index(self):
        cols = self._inner.cols
        return {(r, c): r * cols + c
                for r in range(self._inner.rows) for c in range(cols)}

    @property
    def do_plasticity(self):
        return self._inner.do_plasticity

    @do_plasticity.setter
    def do_plasticity(self, value):
        self._inner.do_plasticity = value

    @property
    def plasticity(self):
        return self._inner.plasticity

    @plasticity.setter
    def plasticity(self, value):
        if isinstance(value, STDP):
            value = value._native()
        self._inner.plasticity = value

    @property
    def electrical_synapse(self):
        return self._inner.electrical_synapse

    @electrical_synapse.setter
    def electrical_synapse(self, v):
        self._inner.electrical_synapse = v

    @property
    def chemical_synapse(self):
        return self._inner.chemical_synapse

    @chemical_synapse.setter
    def chemical_synapse(self, v):
        self._inner.chemical_synapse = v


_ST_SCALARS = ("current_voltage", "v_th", "v_resting", "rate", "step", "dt",
               "chance_of_firing")
_ST_KEYMAP = {"current_voltage": "v"}


class RateSpikeTrainLattice(_LatticeMixin):
    """`RateSpikeTrainLattice` (impl_spike_train_lattice) on ``device``."""

    _KEYMAP = _ST_KEYMAP

    def __init__(self, id=0, device="cuda"):
        self._inner = _STLattice(
            st_models.RateSpikeTrain(nt_kinetics="bounded"), id=id,
            device=device)
        self._prototype = None

    @property
    def inner(self):
        return self._inner

    def populate(self, spike_train, num_rows, num_cols):
        self._prototype = copy.deepcopy(spike_train)
        known = set(self._inner.model.FIELDS) | {"v", "v_th", "v_resting", "dt"}
        over = {}
        for attr in _ST_SCALARS:
            key = _ST_KEYMAP.get(attr, attr)
            if hasattr(spike_train, attr) and key in known:
                over[key] = float(getattr(spike_train, attr))
        over["refractoriness$k"] = spike_train.neural_refractoriness.k

        def install(model, host):
            for t, kin in spike_train.synaptic_neurotransmitters.items():
                # spike trains share the Ionotropic axis in the base
                # framework; the DopaGluGABA axis has the same cardinality
                # so indices map 1:1
                host["nt$mask"][:, int(t)] = True
                host["nt$t_max"][:, int(t)] = kin.t_max
                host["nt$clearance_constant"][:, int(t)] = \
                    kin.clearance_constant

        _populate(self._inner, num_rows, num_cols, install, **over)

    def run_lattice(self, iterations):
        self._inner.run_lattice(iterations)

    _ST_SCALARS = ("rate", "step", "v_th", "v_resting", "chance_of_firing")

    def get_spike_train(self, row, col):
        """`get_spike_train` analog of get_neuron
        (lattices/mod.rs:1067-1086)."""
        if not (0 <= row < self._inner.rows and 0 <= col < self._inner.cols):
            raise KeyError(f"Position ({row}, {col}) not found")
        idx = row * self._inner.cols + col
        proto = copy.deepcopy(self._prototype) if self._prototype \
            else RateSpikeTrain()
        state = self._inner.state
        keys = [k for k in
                [_ST_KEYMAP.get(a, a) for a in self._ST_SCALARS]
                if k in state] + ["v", "last_firing_time", "is_spiking"]
        host = _pull_state(state, keys)
        for attr in self._ST_SCALARS:
            key = _ST_KEYMAP.get(attr, attr)
            if key in host:
                setattr(proto, attr, float(host[key][idx]))
        proto.current_voltage = float(host["v"][idx])
        lft = int(host["last_firing_time"][idx])
        proto.last_firing_time = None if lft < 0 else lft
        proto.is_spiking = bool(host["is_spiking"][idx])
        return proto

    def set_spike_train(self, row, col, neuron):
        if not (0 <= row < self._inner.rows and 0 <= col < self._inner.cols):
            raise KeyError(f"Position ({row}, {col}) not found")
        idx = row * self._inner.cols + col
        state = dict(self._inner.state)
        for attr in self._ST_SCALARS + ("current_voltage",):
            key = _ST_KEYMAP.get(attr, attr)
            if key in state and hasattr(neuron, attr):
                _set_scalar(state, key, idx, float(getattr(neuron, attr)))
        self._inner.state = state


# map spike-train attribute names in views
def _view_getattr(self, name):
    keymap = object.__getattribute__(self, "_keymap")
    key = keymap.get(name, name)
    arrays = object.__getattribute__(self, "_arrays")
    idx = object.__getattribute__(self, "_idx")
    if key in arrays:
        val = arrays[key][idx]
        if name == "last_firing_time":
            return None if val < 0 else int(val)
        return val.item() if hasattr(val, "item") else val
    raise AttributeError(name)


def _view_setattr(self, name, value):
    keymap = object.__getattribute__(self, "_keymap")
    key = keymap.get(name, name)
    arrays = object.__getattribute__(self, "_arrays")
    idx = object.__getattribute__(self, "_idx")
    if key in arrays:
        if name == "last_firing_time":
            value = -1 if value is None else value
        arrays[key][idx] = value
    else:
        raise AttributeError(f"cannot set {name!r} through apply()")


_NeuronView.__getattr__ = _view_getattr
_NeuronView.__setattr__ = _view_setattr


class IzhikevichNeuronNetwork:
    """`IzhikevichNeuronNetwork` (impl_network), on its lattices' device
    (a lattice on another device than the first raises
    `LatticeNetworkError`)."""

    def __init__(self):
        self._inner = _Network()
        self._lattices = {}
        self._st_lattices = {}

    @classmethod
    def generate_network(cls, lattices=(), spike_train_lattices=()):
        net = cls()
        for lat in lattices:
            net.add_lattice(lat)
        for st in spike_train_lattices:
            net.add_spike_train_lattice(st)
        return net

    @property
    def inner(self):
        return self._inner

    def add_lattice(self, lattice):
        self._inner.add_lattice(lattice._inner)
        self._lattices[lattice._inner.id] = lattice

    def add_spike_train_lattice(self, lattice):
        self._inner.add_spike_train_lattice(lattice._inner)
        self._st_lattices[lattice._inner.id] = lattice

    def get_lattice(self, id):
        return self._lattices[id]

    def get_spike_train_lattice(self, id):
        return self._st_lattices[id]

    def connect(self, presynaptic_id, postsynaptic_id,
                connection_conditional, weight_logic=None):
        self._inner.connect(presynaptic_id, postsynaptic_id,
                            connection_conditional, weight_logic)

    def connect_internally(self, id, connection_conditional, weight_logic=None):
        self._inner.connect_internally(id, connection_conditional, weight_logic)

    def apply_lattice(self, id, function):
        self._lattices[id].apply(function)

    def apply_spike_train_lattice(self, id, function):
        self._st_lattices[id].apply(function)

    def apply_spike_train_lattice_given_position(self, id, function):
        self._st_lattices[id].apply_given_position(function)

    def run_lattices(self, iterations):
        self._inner.run_lattices(iterations)

    def get_weight(self, presynaptic, postsynaptic):
        """`get_weight` with GraphPosition args (lattices/mod.rs:914-938):
        same-lattice pairs read the lattice graph, otherwise the connecting
        graph; 0.0 when unconnected."""
        try:
            w = self._inner.lookup_weight(
                self._gp(presynaptic), self._gp(postsynaptic))
        except (LatticeNetworkError, GraphError) as e:
            raise KeyError(str(e))
        return 0.0 if w is None else w

    def edit_weight(self, presynaptic, postsynaptic, weight):
        try:
            self._inner.edit_weight(
                self._gp(presynaptic), self._gp(postsynaptic), weight)
        except (LatticeNetworkError, GraphError) as e:
            raise KeyError(str(e))

    @staticmethod
    def _gp(gp):
        if hasattr(gp, "id") and hasattr(gp, "pos"):
            return (gp.id, tuple(gp.pos))
        return gp

    def get_incoming_connections_within_lattice(self, id, position):
        """(lattices/mod.rs:942-952)"""
        if id not in self._lattices:
            raise KeyError(f"Lattice {id} not found in network")
        return self._lattices[id].get_incoming_connections(position)

    def get_incoming_connectings_across_lattices(self, id, position):
        """Connecting-graph sources of (id, position) as GraphPositions
        (lattices/mod.rs:970-984)."""
        if id not in self._lattices and id not in self._st_lattices:
            raise KeyError(f"Lattice {id} not found in network")
        out = set()
        for (pre_id, post_id), (src, dst, w) in \
                self._inner.connections.items():
            if post_id != id:
                continue
            pre = (self._lattices.get(pre_id)
                   or self._st_lattices.get(pre_id))._inner
            r, c = position
            flat = r * (self._lattices.get(id)
                        or self._st_lattices.get(id))._inner.cols + c
            for i in np.asarray(src)[np.asarray(dst) == flat]:
                out.add(GraphPosition(pre_id,
                                      (int(i) // pre.cols, int(i) % pre.cols)))
        return out

    def get_outgoing_connectings_across_lattices(self, id, position):
        if id not in self._lattices and id not in self._st_lattices:
            raise KeyError(f"Lattice {id} not found in network")
        out = set()
        src_lat = (self._lattices.get(id) or self._st_lattices.get(id))._inner
        r, c = position
        flat = r * src_lat.cols + c
        for (pre_id, post_id), (src, dst, w) in \
                self._inner.connections.items():
            if pre_id != id:
                continue
            post = self._lattices[post_id]._inner
            for i in np.asarray(dst)[np.asarray(src) == flat]:
                out.add(GraphPosition(post_id,
                                      (int(i) // post.cols, int(i) % post.cols)))
        return out

    def clear(self):
        """`LatticeNetwork::clear`: drop every lattice and connection."""
        self._inner = _Network(self._inner.device)
        self._lattices = {}
        self._st_lattices = {}

    def get_all_ids(self):
        return set(self._lattices) | set(self._st_lattices)

    def apply_lattice_given_position(self, id, function):
        self._lattices[id].apply_given_position(function)

    def _global_index(self):
        """GraphPosition -> flat index over lattices then spike trains in
        sorted-id order (the InterleavingGraph ordering)."""
        mapping = {}
        off = 0
        for lid in sorted(self._lattices):
            lat = self._lattices[lid]._inner
            for r in range(lat.rows):
                for c in range(lat.cols):
                    mapping[GraphPosition(lid, (r, c))] = off
                    off += 1
        for lid in sorted(self._st_lattices):
            st = self._st_lattices[lid]._inner
            for r in range(st.rows):
                for c in range(st.cols):
                    mapping[GraphPosition(lid, (r, c))] = off
                    off += 1
        return mapping

    def get_connecting_position_to_index(self):
        """(lattices/mod.rs:905-912)"""
        return self._global_index()

    def get_connecting_weights(self):
        """Dense connecting-graph matrix over the global node ordering,
        0.0 for absent edges (lattices/mod.rs:893-900)."""
        index = self._global_index()
        n = len(index)
        offsets = {}
        for gp, idx in index.items():
            offsets.setdefault(gp.id, idx)   # first index of each lattice
        mat = np.zeros((n, n), np.float32)
        for (pre_id, post_id), (src, dst, w) in \
                self._inner.connections.items():
            mat[np.asarray(src) + offsets[pre_id],
                np.asarray(dst) + offsets[post_id]] = np.asarray(w)
        return mat

    @property
    def update_connecting_graph_history(self):
        return self._inner.update_connecting_graph_history

    @update_connecting_graph_history.setter
    def update_connecting_graph_history(self, value):
        self._inner.update_connecting_graph_history = value

    def get_connecting_graph_history(self):
        return [np.asarray(h) for h in self._inner.connecting_graph_history]

    def get_spike_train(self, id, row, col):
        if id not in self._st_lattices:
            raise KeyError(f"Spike train lattice {id} not found")
        return self._st_lattices[id].get_spike_train(row, col)

    def set_spike_train(self, id, row, col, neuron):
        if id not in self._st_lattices:
            raise KeyError(f"Spike train lattice {id} not found")
        self._st_lattices[id].set_spike_train(row, col, neuron)

    def set_lattice(self, id, lattice):
        """Replace the lattice registered under `id`
        (lattices/mod.rs:1132-1140).  Same validation as add_lattice:
        one shared neuron-model config, and dimensions must match when
        existing connections reference the old flat indices."""
        if id not in self._lattices:
            raise KeyError("Id not found")
        old = self._inner.lattices[id]
        others = [l for i, l in self._inner.lattices.items() if i != id]
        if others and others[0].model != lattice._inner.model:
            raise LatticeNetworkError(
                "all lattices must share one neuron model config")
        if (lattice._inner.rows, lattice._inner.cols) != (old.rows, old.cols) \
                and any(id in key for key in self._inner.connections):
            raise LatticeNetworkError(
                "replacement lattice dimensions must match while "
                "connections reference the old one")
        inner = copy.deepcopy(lattice._inner)
        inner.id = id
        inner.in_network = True
        self._inner.lattices[id] = inner
        self._inner._conn_version += 1
        wrapped = copy.copy(lattice)
        wrapped._inner = inner
        self._lattices[id] = wrapped

    def set_spike_train_lattice(self, id, lattice):
        """Replace the spike-train lattice under `id`; same validation as
        add_spike_train_lattice (one shared model config, dimensions must
        match while connections reference the old flat indices)."""
        if id not in self._st_lattices:
            raise KeyError("Id not found")
        old = self._inner.spike_train_lattices[id]
        others = [l for i, l in self._inner.spike_train_lattices.items()
                  if i != id]
        if others and others[0].model != lattice._inner.model:
            raise LatticeNetworkError(
                "all spike-train lattices must share one model config")
        if (lattice._inner.rows, lattice._inner.cols) != (old.rows, old.cols) \
                and any(id in key for key in self._inner.connections):
            raise LatticeNetworkError(
                "replacement lattice dimensions must match while "
                "connections reference the old one")
        inner = copy.deepcopy(lattice._inner)
        inner.id = id
        inner.in_network = True
        self._inner.spike_train_lattices[id] = inner
        self._inner._conn_version += 1
        wrapped = copy.copy(lattice)
        wrapped._inner = inner
        self._st_lattices[id] = wrapped

    def __repr__(self):
        return (f"{type(self).__name__} {{ lattices: "
                f"{sorted(self._lattices)}, spike_train_lattices: "
                f"{sorted(self._st_lattices)} }}")

    def get_outgoing_connections_within_lattice(self, id, position):
        if id not in self._lattices:
            raise KeyError(f"Lattice {id} not found in network")
        return self._lattices[id].get_outgoing_connections(position)

    def set_dt(self, dt):
        self._inner.set_dt(dt)

    def reset_timing(self):
        self._inner.reset_timing()

    @property
    def electrical_synapse(self):
        return self._inner.electrical_synapse

    @electrical_synapse.setter
    def electrical_synapse(self, v):
        self._inner.electrical_synapse = v

    @property
    def chemical_synapse(self):
        return self._inner.chemical_synapse

    @chemical_synapse.setter
    def chemical_synapse(self, v):
        self._inner.chemical_synapse = v

    @property
    def parallel(self):
        return True  # vectorization is always on

    @parallel.setter
    def parallel(self, v):
        pass


class PoissonLattice(RateSpikeTrainLattice):
    """Poisson spike-train lattice (`PoissonNeuron`, spike_train/mod.rs:259-371)."""

    def __init__(self, id=0, device="cuda"):
        self._inner = _STLattice(
            st_models.PoissonSpikeTrain(nt_kinetics="bounded"), id=id,
            device=device)
        self._prototype = None


# The "GPU" classes: `from_lattice` / `from_network` (impl_lattice_gpu
# `from_lattice`, lattices/mod.rs:335+) copy a lattice or network onto the
# card (``device``, "cuda" by default), tensors that are there already
# deep-copied in place, so that the pair steps independently for parity
# checks, as the reference's Python tests do.


def _copy_to(inner, device):
    """A deep copy of the core lattice or network ``inner`` on ``device``:
    its tensors (members' states and graphs included) copied there, no
    storage shared with ``inner``, cached run plans dropped.  A member
    moved to another device draws its Poisson trains from a new generator
    seeded by its ``seed``."""
    memo = {}
    plan = getattr(inner, "_structured_plan", None)
    if plan is not None:
        memo[id(plan)] = None
    out = copy.deepcopy(inner, memo)
    device = torch.device(device)
    members = [out] + list(getattr(out, "lattices", {}).values()) \
        + list(getattr(out, "spike_train_lattices", {}).values())
    for m in members:
        if getattr(m, "device", None) is None or m.device == device:
            continue
        m.device = device
        if hasattr(m, "_generator"):
            m._generator = None
        if getattr(m, "state", None) is not None:
            m.state = {k: v.to(device) for k, v in m.state.items()}
        if getattr(m, "graph", None) is not None:
            m.graph = copy.copy(m.graph)
            for k, v in vars(m.graph).items():
                if isinstance(v, torch.Tensor):
                    setattr(m.graph, k, v.to(device))
    return out


class IzhikevichNeuronLatticeGPU(IzhikevichNeuronLattice):
    @classmethod
    def from_lattice(cls, lattice, device="cuda"):
        out = cls.__new__(cls)
        out._inner = _copy_to(lattice._inner, device)
        out._prototype = copy.deepcopy(lattice._prototype)
        return out


class IzhikevichNeuronNetworkGPU(IzhikevichNeuronNetwork):
    @classmethod
    def from_network(cls, network, device="cuda"):
        out = cls.__new__(cls)
        out._inner = _copy_to(network._inner, device)
        out._lattices = {}
        out._st_lattices = {}
        for lid, lat in network._lattices.items():
            wrapped = copy.copy(lat)
            wrapped._inner = out._inner.lattices[lid]
            out._lattices[lid] = wrapped
        for lid, st in network._st_lattices.items():
            wrapped = copy.copy(st)
            wrapped._inner = out._inner.spike_train_lattices[lid]
            out._st_lattices[lid] = wrapped
        return out


# ---------------------------------------------------------------------------
# Legacy v0.1 surface: Ionotropic kinetics + ligand gates and the
# HodgkinHuxley / LeakyIntegrateAndFire / (Ionotropic) Izhikevich families
# (the reference's `interface/src/lib.rs:1-3308`).  The reference's legacy
# module names its lattice classes without the "Neuron" infix
# (IzhikevichLattice vs the v0.4 IzhikevichNeuronLattice); both ride the
# same device runtime here.
# ---------------------------------------------------------------------------

# the legacy module spells the inhibitory type "GABAa"
IonotropicNeurotransmitterType.GABAa = IonotropicNeurotransmitterType.GABA

_IONO_NAMES = ("AMPA", "NMDA", "GABA")


class ApproximateNeurotransmitter:
    """`ApproximateNeurotransmitter` (iterate_and_spike/mod.rs:165-180):
    t += dt * -clearance_constant * t + is_spiking * t_max, clamped."""

    def __init__(self, t_max=1.0, t=0.0, clearance_constant=0.01):
        self.t_max = t_max
        self.t = t
        self.clearance_constant = clearance_constant


class ApproximateNeurotransmitters:
    """Container keyed by IonotropicNeurotransmitterType
    (legacy `ApproximateNeurotransmitters`)."""

    def __init__(self):
        self.neurotransmitters = {}

    def set_neurotransmitter(self, neurotransmitter_type, neurotransmitter):
        t = IonotropicNeurotransmitterType(neurotransmitter_type)
        self.neurotransmitters[int(t)] = neurotransmitter


class ApproximateLigandGatedChannel:
    """`ApproximateLigandGatedChannel` — one Ionotropic receptor with the
    reference's per-type conductance/reversal defaults
    (iterate_and_spike/mod.rs:1078-1166)."""

    _DEFAULTS = {0: (1.0, 0.0), 1: (0.6, 0.0), 2: (1.2, -80.0)}

    def __init__(self, neurotransmitter_type):
        t = int(IonotropicNeurotransmitterType(neurotransmitter_type))
        self.neurotransmitter_type = t
        self.g, self.e = self._DEFAULTS[t]
        self.mg = 0.3          # NMDA magnesium block (mod.rs:1133-1137)


class ApproximateLigandGatedChannels:
    def __init__(self):
        self.gates = {}

    def set_ligand_gate(self, neurotransmitter_type, gate):
        t = IonotropicNeurotransmitterType(neurotransmitter_type)
        self.gates[int(t)] = gate


def _install_ionotropic(model, host, neuron):
    """Install legacy-style Ionotropic neurotransmitters + ligand gates
    into a HOST state dict in place (see _install_synapses_host)."""
    nts = getattr(neuron, "ionotropic_neurotransmitters", None)
    gates = getattr(neuron, "ligand_gates", None)
    if nts is not None:
        for t, kin in nts.neurotransmitters.items():
            _host_insert_nt(model, host, _IONO_NAMES[int(t)],
                            t_max=kin.t_max,
                            clearance_constant=kin.clearance_constant,
                            t=kin.t)
    if gates is not None:
        for t, ch in gates.gates.items():
            params = dict(g=ch.g, e=ch.e)
            if int(t) == 1:
                params["mg"] = ch.mg
            _host_insert_receptor(model, host, _IONO_NAMES[int(t)],
                                  **params)
    return host


class _LegacyNeuronBase:
    """Prototype base for the legacy families: plain scalar attributes plus
    Ionotropic neurotransmitter / ligand-gate containers."""

    _SCALARS = ()
    _DEFAULTS = {}

    def __init__(self, **kw):
        for attr, default in self._DEFAULTS.items():
            setattr(self, attr, default)
        self.is_spiking = False
        self.last_firing_time = None
        self.ionotropic_neurotransmitters = None
        self.ligand_gates = None
        for k, v in kw.items():
            setattr(self, k, v)

    def set_neurotransmitters(self, neurotransmitters):
        if isinstance(neurotransmitters, dict):
            container = ApproximateNeurotransmitters()
            for t, kin in neurotransmitters.items():
                container.set_neurotransmitter(t, kin)
            neurotransmitters = container
        self.ionotropic_neurotransmitters = neurotransmitters

    def set_ligand_gates(self, ligand_gates):
        self.ligand_gates = ligand_gates


class HodgkinHuxleyNeuron(_LegacyNeuronBase):
    """Legacy `HodgkinHuxleyNeuron` prototype; defaults follow
    hodgkin_huxley/mod.rs:49-106 (Na/K/K-leak channel params live in the
    lattice state under na$/k$/kleak$ keys)."""

    _SCALARS = ("current_voltage", "c_m", "v_th", "dt", "gap_conductance")
    _DEFAULTS = dict(current_voltage=-65.0, c_m=1.0, v_th=0.0, dt=0.01,
                     gap_conductance=7.0)


class LeakyIntegrateAndFireNeuron(_LegacyNeuronBase):
    """Legacy LIF prototype (integrate_and_fire/mod.rs:108-215)."""

    _SCALARS = ("current_voltage", "v_th", "v_reset", "tref",
                "leak_constant", "integration_constant", "gap_conductance",
                "e_l", "g_l", "tau_m", "c_m", "dt")
    _DEFAULTS = dict(current_voltage=-75.0, v_th=-55.0, v_reset=-75.0,
                     tref=10.0, leak_constant=-1.0, integration_constant=1.0,
                     gap_conductance=7.0, e_l=-75.0, g_l=10.0, tau_m=10.0,
                     c_m=100.0, dt=0.1)


def _legacy_izhikevich_installer(model, host, neuron):
    # the legacy IzhikevichNeuron prototype is the shared class above,
    # which may carry either DopaGluGABA receptors (v0.4 style) or the
    # Ionotropic containers (v0.1 style)
    if getattr(neuron, "ionotropic_neurotransmitters", None) is not None \
            or getattr(neuron, "ligand_gates", None) is not None:
        return _install_ionotropic(model, host, neuron)
    return host


def _make_legacy_lattice(cls_name, model_factory, proto_cls, scalars,
                         keymap, installer, doc):
    class LegacyLattice(_LatticeMixin):
        _SCALARS = scalars
        _KEYMAP = dict(keymap)

        def __init__(self, id=0, device="cuda"):
            self._inner = _Lattice(model_factory(), id=id, device=device)
            self._prototype = None

        @property
        def inner(self):
            return self._inner

        def populate(self, neuron, num_rows, num_cols):
            self._prototype = copy.deepcopy(neuron)
            known = set(self._inner.model.FIELDS)
            over = {}
            for attr in self._SCALARS:
                key = self._KEYMAP.get(attr, attr)
                if hasattr(neuron, attr) and key in known:
                    over[key] = float(getattr(neuron, attr))
            _populate(self._inner, num_rows, num_cols,
                      lambda model, host: installer(model, host, neuron),
                      **over)

        def connect(self, connection_conditional, weight_logic=None):
            self._inner.connect(connection_conditional, weight_logic)

        def connect_stencil(self, **kw):
            self._inner.connect_stencil(**kw)

        def run_lattice(self, iterations):
            self._inner.run_lattice(iterations)

        def get_neuron(self, row, col):
            if not (0 <= row < self._inner.rows
                    and 0 <= col < self._inner.cols):
                raise KeyError(f"position ({row}, {col}) not in lattice")
            idx = row * self._inner.cols + col
            n = copy.deepcopy(self._prototype) if self._prototype \
                else proto_cls()
            state = self._inner.state
            keys = [k for k in
                    [self._KEYMAP.get(a, a) for a in self._SCALARS]
                    if k in state] + ["last_firing_time", "is_spiking"]
            host = _pull_state(state, keys)
            for attr in self._SCALARS:
                key = self._KEYMAP.get(attr, attr)
                if key in host:
                    setattr(n, attr, float(host[key][idx]))
            lft = int(host["last_firing_time"][idx])
            n.last_firing_time = None if lft < 0 else lft
            n.is_spiking = bool(host["is_spiking"][idx])
            return n

        def set_neuron(self, row, col, neuron):
            if not (0 <= row < self._inner.rows
                    and 0 <= col < self._inner.cols):
                raise KeyError(f"position ({row}, {col}) not in lattice")
            idx = row * self._inner.cols + col
            state = dict(self._inner.state)
            for attr in self._SCALARS:
                key = self._KEYMAP.get(attr, attr)
                if key in state and hasattr(neuron, attr):
                    _set_scalar(state, key, idx,
                                float(getattr(neuron, attr)))
            self._inner.state = state

        @property
        def weights(self):
            return IzhikevichNeuronLattice.weights.fget(self)

        @property
        def position_to_index(self):
            cols = self._inner.cols
            return {(r, c): r * cols + c
                    for r in range(self._inner.rows) for c in range(cols)}

        do_plasticity = IzhikevichNeuronLattice.do_plasticity
        plasticity = IzhikevichNeuronLattice.plasticity
        electrical_synapse = IzhikevichNeuronLattice.electrical_synapse
        chemical_synapse = IzhikevichNeuronLattice.chemical_synapse

    LegacyLattice.__name__ = cls_name
    LegacyLattice.__qualname__ = cls_name
    LegacyLattice.__doc__ = doc
    return LegacyLattice


def _hh_model():
    from .models.hodgkin_huxley import HodgkinHuxley
    # the legacy surface pairs HH with Approximate kinetics (the published
    # 0.23.5 crate's default for the python bindings)
    return HodgkinHuxley(nt_kinetics="approximate",
                        rec_kinetics="approximate")


def _lif_model():
    from .models.integrate_and_fire import LeakyIntegrateAndFire
    return LeakyIntegrateAndFire(nt_kinetics="approximate",
                                 rec_kinetics="approximate")


def _iono_izh_model():
    from .models.integrate_and_fire import Izhikevich
    return Izhikevich(nt_kinetics="approximate", rec_kinetics="approximate")


HodgkinHuxleyLattice = _make_legacy_lattice(
    "HodgkinHuxleyLattice", _hh_model, HodgkinHuxleyNeuron,
    HodgkinHuxleyNeuron._SCALARS, {"current_voltage": "v"},
    _install_ionotropic,
    "Legacy `HodgkinHuxleyLattice` (interface/src/lib.rs) on the device "
    "runtime.")

LeakyIntegrateAndFireLattice = _make_legacy_lattice(
    "LeakyIntegrateAndFireLattice", _lif_model, LeakyIntegrateAndFireNeuron,
    LeakyIntegrateAndFireNeuron._SCALARS, {"current_voltage": "v"},
    _install_ionotropic,
    "Legacy LIF lattice on the device runtime.")

IzhikevichLattice = _make_legacy_lattice(
    "IzhikevichLattice", _iono_izh_model, IzhikevichNeuron,
    _IZH_SCALARS, dict(_IZH_KEYMAP), _legacy_izhikevich_installer,
    "Legacy `IzhikevichLattice` (Ionotropic receptors, "
    "interface/src/lib.rs) on the device runtime.")

# legacy prototype methods on the shared IzhikevichNeuron class
IzhikevichNeuron.set_neurotransmitters = \
    _LegacyNeuronBase.set_neurotransmitters
IzhikevichNeuron.set_ligand_gates = _LegacyNeuronBase.set_ligand_gates

# The network wrapper is model-agnostic, but the reference's generated
# network classes are TYPE-LOCKED to one neuron family (impl_network! in
# interface/src/lib.rs monomorphizes per model): adding an HH lattice to
# an IzhikevichNetwork is a compile error there, so the legacy names here
# reject mismatched lattice families at add time instead of silently
# accepting them.
def _typed_legacy_network(cls_name, model_cls_path, doc):
    class TypedLegacyNetwork(IzhikevichNeuronNetwork):
        def _model_cls(self):
            import importlib
            mod_name, attr = model_cls_path.rsplit(".", 1)
            return getattr(importlib.import_module(mod_name, __package__),
                           attr)

        def add_lattice(self, lattice):
            model_cls = self._model_cls()
            if not isinstance(lattice._inner.model, model_cls):
                raise TypeError(
                    f"{type(self).__name__} accepts only lattices of "
                    f"{model_cls.__name__} neurons, got "
                    f"{type(lattice._inner.model).__name__} (the reference's "
                    "generated network classes are monomorphic per model)")
            super().add_lattice(lattice)

    TypedLegacyNetwork.__name__ = cls_name
    TypedLegacyNetwork.__qualname__ = cls_name
    TypedLegacyNetwork.__doc__ = doc
    return TypedLegacyNetwork


HodgkinHuxleyNetwork = _typed_legacy_network(
    "HodgkinHuxleyNetwork", ".models.hodgkin_huxley.HodgkinHuxley",
    "Legacy `HodgkinHuxleyNetwork` (interface/src/lib.rs): type-locked to "
    "HodgkinHuxley lattices.")
LeakyIntegrateAndFireNetwork = _typed_legacy_network(
    "LeakyIntegrateAndFireNetwork",
    ".models.integrate_and_fire.LeakyIntegrateAndFire",
    "Legacy LIF network: type-locked to LeakyIntegrateAndFire lattices.")
IzhikevichNetwork = _typed_legacy_network(
    "IzhikevichNetwork", ".models.integrate_and_fire.Izhikevich",
    "Legacy `IzhikevichNetwork` (Ionotropic receptors, interface/src/"
    "lib.rs): type-locked to Izhikevich lattices.")


# ---------------------------------------------------------------------------
# Legacy v0.1 tail: Destexhe ligand-gated family, per-channel ion-channel
# pyclasses, and the Dopa* legacy names
# (the reference's `interface/src/lib.rs:139-640, 1141-1211, 1561-1712,
# 2663-3108`).  These are host-side prototype objects with working math —
# the same role they play in the reference's legacy module, where users
# compose/step single neurons on the host before populating lattices.
# ---------------------------------------------------------------------------

# the legacy enum has a distinct GABAb variant (interface/src/lib.rs:80-88);
# the device receptor axis (AMPA/NMDA/GABA) has no GABAb slot, so it exists
# as a host-only key for the Destexhe prototype containers
IonotropicNeurotransmitterType.GABAb = 3


class DestexheNeurotransmitter:
    """`PyDestexheNeurotransmitter` (interface/src/lib.rs:2684-2717):
    voltage-sigmoid release, ``t = t_max / (1 + exp(-(v - v_p) / k_p))``
    (iterate_and_spike/mod.rs:147-159).  Constructor defaults follow the
    legacy pyclass signature (lib.rs:2702)."""

    def __init__(self, t_max=1.0, t=0.0, v_p=5.0, k_p=2.0):
        self.t_max = t_max
        self.t = t
        self.v_p = v_p
        self.k_p = k_p

    def apply_t_change(self, voltage, _dt=0.0):
        self.t = float(self.t_max
                       / (1.0 + np.exp(-(voltage - self.v_p) / self.k_p)))

    def __repr__(self):
        return (f"DestexheNeurotransmitter {{ t_max: {self.t_max}, "
                f"t: {self.t}, v_p: {self.v_p}, k_p: {self.k_p} }}")


class DestexheNeurotransmitters:
    """`PyDestexheNeurotransmitters` (interface/src/lib.rs:2721-2783):
    container keyed by IonotropicNeurotransmitterType.  Per-type
    constructors in the published 0.23.5 crate share the backend's
    sigmoid defaults (t_max=1, v_p=2, k_p=5 — iterate_and_spike/mod.rs:
    137-145; the 0.23.5 source itself is not vendored in the tree)."""

    def __init__(self, neurotransmitter_types=None):
        self.neurotransmitters = {}
        for t in (neurotransmitter_types or ()):
            self.neurotransmitters[int(t)] = DestexheNeurotransmitter(
                t_max=1.0, t=0.0, v_p=2.0, k_p=5.0)

    def __getitem__(self, neurotransmitter_type):
        key = int(neurotransmitter_type)
        if key not in self.neurotransmitters:
            raise KeyError(f"{neurotransmitter_type!r} not found")
        return self.neurotransmitters[key]

    def set_neurotransmitter(self, neurotransmitter_type, neurotransmitter):
        self.neurotransmitters[int(neurotransmitter_type)] = neurotransmitter

    def apply_t_changes(self, voltage, dt):
        for nt in self.neurotransmitters.values():
            nt.apply_t_change(voltage, dt)


class DestexheReceptor:
    """`PyDestexheReceptor` (interface/src/lib.rs:2783-2817):
    ``r += (alpha * T * (1 - r) - beta * r) * dt``
    (iterate_and_spike/mod.rs:394-428; ops/kinetics.rec_destexhe)."""

    def __init__(self, r=1.0, alpha=1.0, beta=1.0):
        self.r = r
        self.alpha = alpha
        self.beta = beta

    def apply_r_change(self, neurotransmitter_conc, dt):
        self.r = float(self.r + (self.alpha * neurotransmitter_conc
                                 * (1.0 - self.r) - self.beta * self.r) * dt)


class DestexheLigandGatedChannel:
    """`PyDestexheLigandGatedChannel` (interface/src/lib.rs:2817-2921).

    Per-type (g, reversal) pairs mirror the Ionotropic receptor defaults
    the backend keeps at HEAD (iterate_and_spike/mod.rs:1078-1318; GABAb is
    the K+-mediated channel of the Destexhe model family); per-type
    receptor (alpha, beta) rate constants follow the Destexhe-Mainen-
    Sejnowski (1998) kinetics table the backend's docstring cites
    (iterate_and_spike/mod.rs:123-125) — the published 0.23.5 crate that
    defined ``ampa_default()`` et al. is not vendored in the tree.  The
    NMDA variant carries the legacy B(V) magnesium block
    ``1 / (1 + exp(-0.062 v) * mg / 3.57)`` (interface/temp_build.rs:796).
    """

    #                       g      e      alpha   beta
    _DEFAULTS = {
        0: (1.0, 0.0, 1.1, 0.19),        # AMPA
        1: (0.6, 0.0, 0.072, 0.0066),    # NMDA (B(V) Mg block)
        2: (1.2, -80.0, 5.0, 0.18),      # GABAa
        3: (0.06, -95.0, 0.016, 0.0047),  # GABAb (K+ reversal)
    }

    def __init__(self, receptor_type):
        t = int(receptor_type)
        g, e, alpha, beta = self._DEFAULTS[t]
        self.neurotransmitter_type = t
        self.g = g
        self.reversal = e
        self.current = 0.0
        self.mg = 0.33 if t == 1 else 0.0
        self.receptor = DestexheReceptor(r=0.0, alpha=alpha, beta=beta)

    def get_receptor(self):
        return self.receptor

    def set_receptor(self, receptor):
        self.receptor = receptor

    def __repr__(self):
        return (f"DestexheLigandGatedChannel {{ g: {self.g}, "
                f"reversal: {self.reversal}, current: {self.current} }}")


class DestexheLigandGatedChannels:
    """`PyDestexheLigandGatedChannels` (interface/src/lib.rs:2834-2908)."""

    def __init__(self, neurotransmitter_types=None):
        self.ligand_gates = {}
        for t in (neurotransmitter_types or ()):
            self.ligand_gates[int(t)] = DestexheLigandGatedChannel(int(t))

    def __getitem__(self, neurotransmitter_type):
        key = int(neurotransmitter_type)
        if key not in self.ligand_gates:
            raise KeyError(f"{neurotransmitter_type!r} not found")
        return self.ligand_gates[key]

    def set_ligand_gate(self, neurotransmitter_type, ligand_gate):
        self.ligand_gates[int(neurotransmitter_type)] = ligand_gate

    def update_receptor_kinetics(self, neurotransmitter_concs, dt):
        """`LigandGatedChannels::update_receptor_kinetics`: each gate whose
        type appears in the concentration dict advances its receptor."""
        for t, conc in neurotransmitter_concs.items():
            gate = self.ligand_gates.get(int(t))
            if gate is not None:
                gate.receptor.apply_r_change(conc, dt)


# --- per-channel ion-channel pyclasses (interface/src/lib.rs:2923-3108) ---


class BasicGatingVariable:
    """`PyBasicGatingVariable` (interface/src/lib.rs:2923-2963);
    math mirrors `BasicGatingVariable` (ion_channels/mod.rs:14-45) and the
    vectorized `models.ion_channels.gate_update`."""

    def __init__(self, alpha=0.0, beta=0.0, state=0.0):
        self.alpha = alpha
        self.beta = beta
        self.state = state

    def init_state(self):
        self.state = self.alpha / (self.alpha + self.beta)

    def update(self, dt):
        self.state += dt * (self.alpha * (1.0 - self.state)
                            - self.beta * self.state)

    def __repr__(self):
        return (f"BasicGatingVariable {{ alpha: {self.alpha}, "
                f"beta: {self.beta}, state: {self.state} }}")


class NaIonChannel:
    """`PyNaIonChannel` (interface/src/lib.rs:2963-3023).  Constructor
    defaults follow the legacy pyclass signature (g_na=120, e_na=115);
    gate-rate equations mirror `NaIonChannel` at backend HEAD
    (ion_channels/mod.rs:192-240; `models.ion_channels.na_channel_update`),
    so a pyclass stepped host-side matches the device lattice exactly."""

    def __init__(self, g_na=120.0, e_na=115.0, m=None, h=None, current=0.0):
        self.g_na = g_na
        self.e_na = e_na
        self.m = m or BasicGatingVariable()
        self.h = h or BasicGatingVariable()
        self.current = current

    def update_current(self, voltage, dt):
        v = voltage
        self.m.alpha = 0.1 * ((v + 40.0) / (1.0 - np.exp(-(v + 40.0) / 10.0)))
        self.m.beta = 4.0 * np.exp(-(v + 65.0) / 18.0)
        self.h.alpha = 0.07 * np.exp(-(v + 65.0) / 20.0)
        self.h.beta = 1.0 / (np.exp(-(v + 35.0) / 10.0) + 1.0)
        self.m.update(dt)
        self.h.update(dt)
        self.current = (self.m.state ** 3 * self.h.state * self.g_na
                        * (v - self.e_na))

    def get_m(self):
        return self.m

    def set_m(self, m):
        self.m = m

    def get_h(self):
        return self.h

    def set_h(self, h):
        self.h = h

    def __repr__(self):
        return (f"NaIonChannel {{ g_na: {self.g_na}, e_na: {self.e_na}, "
                f"current: {self.current} }}")


class KIonChannel:
    """`PyKIonChannel` (interface/src/lib.rs:3023-3073); rates from
    `KIonChannel` (ion_channels/mod.rs:244-286)."""

    def __init__(self, g_k=36.0, e_k=-12.0, n=None, current=0.0):
        self.g_k = g_k
        self.e_k = e_k
        self.n = n or BasicGatingVariable()
        self.current = current

    def update_current(self, voltage, dt):
        v = voltage
        self.n.alpha = 0.01 * (v + 55.0) / (1.0 - np.exp(-(v + 55.0) / 10.0))
        self.n.beta = 0.125 * np.exp(-(v + 65.0) / 80.0)
        self.n.update(dt)
        self.current = self.n.state ** 4 * self.g_k * (v - self.e_k)

    def get_n(self):
        return self.n

    def set_n(self, n):
        self.n = n

    def __repr__(self):
        return (f"KIonChannel {{ g_k: {self.g_k}, e_k: {self.e_k}, "
                f"current: {self.current} }}")


class KLeakChannel:
    """`PyKLeakChannel` (interface/src/lib.rs:3073-3108); timestep-
    independent (`KLeakChannel`, ion_channels/mod.rs:289-317)."""

    def __init__(self, g_k_leak=0.3, e_k_leak=10.6, current=0.0):
        self.g_k_leak = g_k_leak
        self.e_k_leak = e_k_leak
        self.current = current

    def update_current(self, voltage):
        self.current = self.g_k_leak * (voltage - self.e_k_leak)

    def __repr__(self):
        return (f"KLeakChannel {{ g_k_leak: {self.g_k_leak}, "
                f"e_k_leak: {self.e_k_leak}, current: {self.current} }}")


# --- legacy Dopa* surface (interface/src/lib.rs:139-640, 1141-1211,
#     1561-1712, 2663-2683) ---


class ApproximateReceptor:
    """`PyApproximateReceptor` (interface/src/lib.rs:737-769): r = t
    (iterate_and_spike/mod.rs:430-446)."""

    def __init__(self, r=0.0):
        self.r = r

    def apply_r_change(self, neurotransmitter_conc, _dt=0.0):
        self.r = float(neurotransmitter_conc)


class DopaGluGABAApproximateNeurotransmitters:
    """`PyDopaGluGABAApproximateNeurotransmitters`
    (interface/src/lib.rs:139-194): container keyed by
    DopaGluGABANeurotransmitterType holding ApproximateNeurotransmitter."""

    def __init__(self, neurotransmitter_types=None):
        self.neurotransmitters = {}
        for t in (neurotransmitter_types or ()):
            self.neurotransmitters[int(t)] = ApproximateNeurotransmitter()

    def __getitem__(self, neurotransmitter_type):
        key = int(neurotransmitter_type)
        if key not in self.neurotransmitters:
            raise KeyError(f"{neurotransmitter_type!r} not found")
        return self.neurotransmitters[key]

    def set_neurotransmitter(self, neurotransmitter_type, neurotransmitter):
        self.neurotransmitters[int(neurotransmitter_type)] = neurotransmitter

    def apply_t_changes(self, voltage, dt, is_spiking=False):
        """`ApproximateNeurotransmitter::apply_t_change`
        (iterate_and_spike/mod.rs:180-195): spike-gated release with
        clearance decay, clamped to [0, t_max]."""
        for nt in self.neurotransmitters.values():
            t = nt.t + dt * -nt.clearance_constant * nt.t \
                + (nt.t_max if is_spiking else 0.0)
            nt.t = float(min(max(t, 0.0), nt.t_max))


class DopaGluGABAReceptors(DopaGluGABA):
    """`PyDopaGluGABAReceptors` (interface/src/lib.rs:422-524): the legacy
    spelling of the v0.4 `DopaGluGABA` receptor set, with
    get_receptor/set_receptor instead of insert.  Subclasses `DopaGluGABA`
    so the lattice populate installers consume it unchanged."""

    def __init__(self, inh_modifier=1.0, nmda_modifier=1.0):
        super().__init__()
        self.inh_modifier = inh_modifier
        self.nmda_modifier = nmda_modifier
        # dopamine receptor always present (DopaGluGABAReceptors::default)
        self.receptors[int(DopaGluGABANeurotransmitterType.Dopamine)] = \
            DopamineReceptor()

    _EXPECTED = {0: GlutamateReceptor, 1: GABAReceptor, 2: DopamineReceptor}

    def get_receptor(self, receptor_type):
        key = int(DopaGluGABANeurotransmitterType(receptor_type))
        if key not in self.receptors:
            raise ValueError(
                f"{DopaGluGABANeurotransmitterType(key).name} receptor "
                f"is not set")
        return self.receptors[key]

    def set_receptor(self, receptor_type, receptor):
        key = int(DopaGluGABANeurotransmitterType(receptor_type))
        if not isinstance(receptor, self._EXPECTED[key]):
            raise ValueError(
                f"receptor type mismatch for "
                f"{DopaGluGABANeurotransmitterType(key).name}: "
                f"{type(receptor).__name__}")
        self.receptors[key] = receptor

    # the v0.4 installer consumes `.receptors` dicts, so the legacy class
    # plugs into _install_synapses_host unchanged
    def insert(self, receptor_type, receptor):
        self.set_receptor(receptor_type, receptor)


class DopaIzhikevichNeuron:
    """`PyDopaIzhikevichNeuron` (interface/src/lib.rs:524-637): the legacy
    Izhikevich prototype with DopaGluGABA receptors (w_value field name,
    current_voltage=-65 default) and host-side stepping."""

    def __init__(self, a=0.02, b=0.2, c=-55.0, d=8.0, v_th=30.0, dt=0.1,
                 current_voltage=-65.0, w_value=30.0, gap_conductance=10.0,
                 tau_m=1.0, c_m=100.0, synaptic_neurotransmitters=None,
                 receptors=None):
        self.a = a
        self.b = b
        self.c = c
        self.d = d
        self.v_th = v_th
        self.dt = dt
        self.current_voltage = current_voltage
        self.w_value = w_value
        self.gap_conductance = gap_conductance
        self.tau_m = tau_m
        self.c_m = c_m
        self.is_spiking = False
        self.last_firing_time = None
        self.synaptic_neurotransmitters = synaptic_neurotransmitters \
            or DopaGluGABAApproximateNeurotransmitters()
        self.receptors = receptors or DopaGluGABAReceptors()

    def iterate_and_spike(self, i):
        """Host-side Izhikevich Euler step + spike handling
        (integrate_and_fire/mod.rs:1251-1268)."""
        v, w = self.current_voltage, self.w_value
        dv = (0.04 * v * v + 5.0 * v + 140.0 - w + i) * (self.dt / self.c_m)
        dw = (self.a * (self.b * v - w)) * (self.dt / self.tau_m)
        self.current_voltage = v + dv
        self.w_value = w + dw
        self.is_spiking = self.current_voltage >= self.v_th
        if self.is_spiking:
            self.current_voltage = self.c
            self.w_value += self.d
        return self.is_spiking

    def get_neurotransmitters(self):
        return self.synaptic_neurotransmitters

    def set_neurotransmitters(self, neurotransmitters):
        self.synaptic_neurotransmitters = neurotransmitters

    def get_receptors(self):
        return self.receptors

    def set_receptors(self, receptors):
        self.receptors = receptors


class DopaPoissonNeuron(PoissonNeuron):
    """`PyDopaPoissonNeuron` (interface/src/lib.rs:1140-1211): Poisson
    prototype whose neurotransmitter axis is DopaGluGABA."""

    def set_synaptic_neurotransmitters(self, mapping):
        # accept both the legacy container and plain dicts; store the
        # plain dict form the lattice populate installers consume
        if isinstance(mapping, DopaGluGABAApproximateNeurotransmitters):
            mapping = mapping.neurotransmitters
        self.synaptic_neurotransmitters = dict(mapping)

    # the legacy pyclass spells it set_neurotransmitters
    # (interface/src/lib.rs:1188)
    set_neurotransmitters = set_synaptic_neurotransmitters


_DOPA_IZH_SCALARS = ("current_voltage", "w_value", "a", "b", "c", "d",
                     "v_th", "tau_m", "c_m", "dt", "gap_conductance")


class DopaIzhikevichLattice(IzhikevichNeuronLattice):
    """`PyDopaIzhikevichLattice` (interface/src/lib.rs:1561-1680): the
    legacy name/shape over the same DopaGluGABA Izhikevich runtime as the
    v0.4 `IzhikevichNeuronLattice` (w_value attribute spelling)."""

    _SCALARS = _DOPA_IZH_SCALARS
    _KEYMAP = {"current_voltage": "v", "w_value": "w"}

    def populate(self, neuron, num_rows, num_cols):
        self._prototype = copy.deepcopy(neuron)
        over = {self._KEYMAP.get(a, a): float(getattr(neuron, a))
                for a in self._SCALARS}

        def install(model, host):
            # legacy neurotransmitter container -> host state
            nts = neuron.synaptic_neurotransmitters
            if isinstance(nts, DopaGluGABAApproximateNeurotransmitters):
                nts = nts.neurotransmitters
            for t, kin in nts.items():
                name = DopaGluGABANeurotransmitterType(int(t)).name
                _host_insert_nt(model, host, name, t_max=kin.t_max,
                                clearance_constant=kin.clearance_constant,
                                t=kin.t)
            proxy = copy.copy(neuron)
            proxy.synaptic_neurotransmitters = {}
            proxy.receptors = neuron.receptors
            _install_synapses_host(model, host, proxy)

        _populate(self._inner, num_rows, num_cols, install, **over)

    def get_neuron(self, row, col):
        self._check_pos(row, col)
        idx = row * self._inner.cols + col
        n = copy.deepcopy(self._prototype) if self._prototype \
            else DopaIzhikevichNeuron()
        keys = [self._KEYMAP.get(a, a) for a in self._SCALARS]
        host = _pull_state(self._inner.state,
                           keys + ["last_firing_time", "is_spiking"])
        for attr in self._SCALARS:
            setattr(n, attr, float(host[self._KEYMAP.get(attr, attr)][idx]))
        lft = int(host["last_firing_time"][idx])
        n.last_firing_time = None if lft < 0 else lft
        n.is_spiking = bool(host["is_spiking"][idx])
        return n

    def set_neuron(self, row, col, neuron):
        self._check_pos(row, col)
        idx = row * self._inner.cols + col
        state = dict(self._inner.state)
        for attr in self._SCALARS:
            _set_scalar(state, self._KEYMAP.get(attr, attr), idx,
                        float(getattr(neuron, attr)))
        self._inner.state = state


class DopaPoissonLattice(PoissonLattice):
    """`PyDopaPoissonLattice` (interface/src/lib.rs:1696-1848): legacy name
    over the Poisson runtime; accepts DopaPoissonNeuron prototypes (the
    DopaGluGABA axis has the same cardinality as Ionotropic, so the
    per-type indices map 1:1, exactly like the v0.4 PoissonLattice)."""


# the network wrapper is model-agnostic (see legacy aliases above)
DopaIzhikevichNetwork = IzhikevichNeuronNetwork

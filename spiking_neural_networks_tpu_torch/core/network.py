"""Multi-lattice network runtime: lattices, spike-train lattices and the
connections between them.

PyTorch counterpart of ``spiking_neural_networks_tpu/core/network.py``.
`LatticeNetwork.run_lattices` runs the structure-preserving runner
(`core/structured.py`), which keeps every lattice's state, its graph and
each connection's operator apart.  A step, as in the JAX package:

1. phase A: every lattice's electrical input from the previous state;
   spike-train sources contribute ``w * refractoriness_effect`` (no
   ``v_post`` subtraction), neuron sources ``w * (v_pre - v_post)``, all
   averaged over the total in-degree; with ``chemical_synapse``, per
   neurotransmitter type, the weighted concentrations of the present
   sources over their count;
2. phase B: every lattice advances (receptors, then the model step, then
   neurotransmitter release); firing times take the network clock;
3. deferred STDP within and across lattices: an edge is updated once per
   spiking endpoint whose lattice has plasticity on;
4. the clock increments and the member clocks sync;
5. spike-train lattices step last, with the pre-increment clock as their
   firing time.

The network owns one `torch.Generator` on its device, seeded by ``seed``,
from which the Poisson trains draw.  The JAX package's flat COO runner
(taken for ``update_connecting_graph_history`` or a subclass),
`run_lattices_pipelined` and `shard` are not ported: they raise
`NotImplementedError` naming their ROADMAP items.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import LatticeNetworkError
from ..models.base import NEVER
from ..ops.graph import DenseGraph, SparseGraph, StencilGraph, positions
from .history import (GridVoltageHistory, history_step_bytes,
                      resolve_history_chunk)
from .plasticity import STDP
from .structured import (nt_flags, resolve_structured_plan, run_structured,
                         write_back_connections)

FLAT_RUNNER_NOT_PORTED = (
    "the flat COO network runner (taken for update_connecting_graph_history "
    "or a LatticeNetwork subclass) is not ported to the PyTorch package yet "
    "(ROADMAP queue 1, item 6)")
MULTI_GPU_NOT_PORTED = (
    "{} is not ported to the PyTorch package yet (ROADMAP queue 1, "
    "item 14: multi-GPU)")


def _graph_to_coo(graph):
    """Host ``(src, dst, w, provenance)`` arrays of any lattice graph: the
    edges of a `DenseGraph` in row-major order, of a `SparseGraph` as
    stored, of a `StencilGraph` offset by offset (its provenance holds each
    edge's (offset, row, col) slot)."""
    if isinstance(graph, DenseGraph):
        mask = graph.mask.cpu().numpy()
        w = graph.weights.cpu().numpy()
        src, dst = np.nonzero(mask)
        return src, dst, w[src, dst], ("dense", None)
    if isinstance(graph, SparseGraph):
        return (graph.src.cpu().numpy(), graph.dst.cpu().numpy(),
                graph.weights.cpu().numpy(), ("sparse", None))
    if isinstance(graph, StencilGraph):
        rows, cols = graph.shape
        mask = graph.mask.cpu().numpy()
        w = graph.weights.cpu().numpy()
        srcs, dsts, ws, prov = [], [], [], []
        rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
        for o, (dr, dc) in enumerate(graph.offsets):
            m = mask[o]
            r, c = rr[m], cc[m]
            srcs.append((r + dr) * cols + (c + dc))
            dsts.append(r * cols + c)
            ws.append(w[o][m])
            prov.append(np.stack([np.full(r.shape, o), r, c], axis=-1))
        return (np.concatenate(srcs), np.concatenate(dsts),
                np.concatenate(ws), ("stencil", np.concatenate(prov)))
    raise TypeError(f"unsupported graph type {type(graph)}")


class SpikeTrainLattice:
    """A grid of spike-train generators on ``device``; no incoming
    connections allowed.  Poisson trains draw from a `torch.Generator`
    seeded by ``seed`` when they run standalone."""

    def __init__(self, model, id=0, device="cuda"):
        self.model = model
        self.id = id
        self.device = torch.device(device)
        self.state = None
        self.rows = self.cols = 0
        self.update_grid_history = False
        self.grid_history = GridVoltageHistory()
        self.internal_clock = 0
        self.history_chunk = None  # None = auto (core/history)
        self.in_network = False
        self.seed = 0
        self._generator = None

    @property
    def n(self):
        return self.rows * self.cols

    def populate(self, rows, cols, **overrides):
        if self.in_network and (rows, cols) != (self.rows, self.cols):
            raise ValueError("dimensions must match when lattice is in a "
                             "network")
        self.rows, self.cols = rows, cols
        self.state = self.model.init_state(rows * cols, device=self.device,
                                           **overrides)

    def apply(self, fn):
        self.state = dict(fn(dict(self.state)))

    def apply_given_position(self, fn):
        rr, cc = torch.meshgrid(torch.arange(self.rows, device=self.device),
                                torch.arange(self.cols, device=self.device),
                                indexing="ij")
        self.state = dict(fn(rr.reshape(-1), cc.reshape(-1), dict(self.state)))

    def shard(self, mesh, axis="tp"):
        raise NotImplementedError(MULTI_GPU_NOT_PORTED.format("shard"))

    def set_dt(self, dt):
        """Poisson trains rescale their chance of firing by the ratio of
        the new dt to the old."""
        if "chance_of_firing" in self.state:
            scalar = torch.full_like(self.state["dt"], dt) / self.state["dt"]
            self.state["chance_of_firing"] = \
                self.state["chance_of_firing"] * scalar
        self.state["dt"] = torch.full_like(self.state["dt"], dt)

    def reset_timing(self):
        self.internal_clock = 0
        self.state["last_firing_time"] = torch.full_like(
            self.state["last_firing_time"], NEVER)

    def reset_history(self):
        self.grid_history.reset()

    def generator(self):
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(self.seed)
        return self._generator

    def run_lattice(self, iterations):
        """Standalone run, in chunks that bound the history on the device."""
        hchunk = resolve_history_chunk(
            self.history_chunk,
            history_step_bytes(self.grid_history.kind, self.n)
            if self.update_grid_history else 0)
        remaining = iterations
        while remaining > 0:
            chunk = min(remaining, hchunk) \
                if self.update_grid_history else remaining
            self._run_chunk(chunk)
            remaining -= chunk

    def _run_chunk(self, length):
        state, clock, ys = self.state, self.internal_clock, []
        generator = self.generator()
        for _ in range(length):
            state, spikes = self.model.step(state, generator, clock)
            state["last_firing_time"] = \
                state["last_firing_time"].masked_fill(spikes, clock)
            clock += 1
            if self.update_grid_history:
                ys.append(self.grid_history.readout(
                    state, (self.rows, self.cols)))
        self.state = state
        self.internal_clock += length
        if ys:
            self.grid_history.extend(torch.stack(ys).cpu())

    def voltages(self):
        return self.state["v"].reshape(self.rows, self.cols).cpu().numpy()


class LatticeNetwork:
    """Lattices and spike-train lattices connected by inter-lattice edges.

    All lattices share one neuron model config and all spike-train
    lattices one train model config.  ``use_kernel`` picks the route as
    for `Lattice`: None (auto) takes the network kernel route when the
    states are on a CUDA device and `ops.network_kernels.
    plain_network_spec` holds; True takes it wherever the gate holds (on
    the CPU the wrapper runs the kernels' plain twin); False always runs
    the plain step loop.  ``_last_run_fused`` is ``("network", emit)``
    after a kernel-route chunk of an electrical network, ``("chemical",
    emit)`` after one of a chemical network, ``("flat", emit)`` and
    ``("flat-chemical", emit)`` after one in the (1, N) row layout of dense
    graphs and dense blocks, else False.
    """

    # the structure-preserving runner; False asks for the flat COO runner
    structured = True

    def __init__(self, device=None):
        self.lattices = {}
        self.spike_train_lattices = {}
        # (pre_id, post_id) -> host COO (src_local, dst_local, w)
        self.connections = {}
        self.electrical_synapse = True
        self.chemical_synapse = False
        self.update_connecting_graph_history = False
        self.connecting_graph_history = []
        self.internal_clock = 0
        self.history_chunk = None  # None = auto (core/history)
        self.use_kernel = None
        self._last_run_fused = False
        self.device = None if device is None else torch.device(device)
        self.seed = 0
        self._generator = None
        # bumped on any topology or weight edit; the structured plan (and
        # its device-resident connection weights) is cached against it
        self._conn_version = 0
        self._structured_plan = None

    # -- construction ----------------------------------------------------------
    @classmethod
    def generate_network(cls, lattices=(), spike_train_lattices=(),
                         device=None):
        net = cls(device)
        for lat in lattices:
            net.add_lattice(lat)
        for st in spike_train_lattices:
            net.add_spike_train_lattice(st)
        return net

    def _check_id(self, id):
        if id in self.lattices or id in self.spike_train_lattices:
            raise LatticeNetworkError(f"id {id} already present in network")

    def _check_device(self, lattice):
        if self.device is None:
            self.device = lattice.device
        elif lattice.device != self.device:
            raise LatticeNetworkError(
                f"lattice {lattice.id} is on {lattice.device}, the network "
                f"on {self.device}")

    def add_lattice(self, lattice):
        self._check_id(lattice.id)
        if self.lattices:
            first = next(iter(self.lattices.values()))
            if first.model != lattice.model:
                raise LatticeNetworkError(
                    "all lattices must share one neuron model config")
        self._check_device(lattice)
        lattice.in_network = True
        self.lattices[lattice.id] = lattice
        self._conn_version += 1

    def add_spike_train_lattice(self, lattice):
        self._check_id(lattice.id)
        if self.spike_train_lattices:
            first = next(iter(self.spike_train_lattices.values()))
            if first.model != lattice.model:
                raise LatticeNetworkError(
                    "all spike-train lattices must share one model config")
        self._check_device(lattice)
        lattice.in_network = True
        self.spike_train_lattices[lattice.id] = lattice
        self._conn_version += 1

    def get_lattice(self, id):
        return self.lattices[id]

    def get_spike_train_lattice(self, id):
        return self.spike_train_lattices[id]

    def generator(self):
        """The network's `torch.Generator` on its device, seeded by
        ``seed`` when first used."""
        if self._generator is None:
            self._generator = torch.Generator(device=self.device or "cpu")
            self._generator.manual_seed(self.seed)
        return self._generator

    def shard(self, mesh, axis="tp"):
        raise NotImplementedError(MULTI_GPU_NOT_PORTED.format("shard"))

    def set_dt(self, dt):
        for lat in self.lattices.values():
            lat.set_dt(dt)
        for st in self.spike_train_lattices.values():
            st.set_dt(dt)

    def reset_timing(self):
        self.internal_clock = 0
        for lat in self.lattices.values():
            lat.reset_timing()
        for st in self.spike_train_lattices.values():
            st.reset_timing()

    # -- connectivity -----------------------------------------------------------
    def connect(self, presynaptic_id, postsynaptic_id, connecting_conditional,
                weight_logic=None):
        """Connect two lattices by a predicate over (pre, post) positions,
        overwriting the existing pre -> post edges; spike-train lattices
        cannot be postsynaptic.  O(N_pre * N_post) host calls."""
        if postsynaptic_id in self.spike_train_lattices:
            raise LatticeNetworkError(
                "spike-train lattices cannot be postsynaptic")
        if postsynaptic_id not in self.lattices:
            raise KeyError(f"unknown postsynaptic id {postsynaptic_id}")
        if presynaptic_id == postsynaptic_id:
            return self.connect_internally(
                presynaptic_id, connecting_conditional, weight_logic)
        pre = self.lattices.get(presynaptic_id) \
            or self.spike_train_lattices.get(presynaptic_id)
        if pre is None:
            raise KeyError(f"unknown presynaptic id {presynaptic_id}")
        post = self.lattices[postsynaptic_id]
        pre_pos = positions(pre.rows, pre.cols)
        post_pos = positions(post.rows, post.cols)
        src, dst, w = [], [], []
        for i, p1 in enumerate(pre_pos):
            t1 = (int(p1[0]), int(p1[1]))
            for j, p2 in enumerate(post_pos):
                t2 = (int(p2[0]), int(p2[1]))
                if connecting_conditional(t1, t2):
                    src.append(i)
                    dst.append(j)
                    w.append(1.0 if weight_logic is None
                             else weight_logic(t1, t2))
        self.connections[(presynaptic_id, postsynaptic_id)] = (
            np.asarray(src, np.int64), np.asarray(dst, np.int64),
            np.asarray(w, np.float32))
        self._conn_version += 1

    def connect_vectorized(self, presynaptic_id, postsynaptic_id, fn):
        """``fn(pre_r, pre_c, post_r, post_c)`` -> weight array over the
        (N_pre, N_post) position product, NaN where there is no edge."""
        pre = self.lattices.get(presynaptic_id) \
            or self.spike_train_lattices.get(presynaptic_id)
        post = self.lattices[postsynaptic_id]
        pre_pos = positions(pre.rows, pre.cols)
        post_pos = positions(post.rows, post.cols)
        w = np.asarray(fn(pre_pos[:, None, 0], pre_pos[:, None, 1],
                          post_pos[None, :, 0], post_pos[None, :, 1]),
                       np.float32)
        src, dst = np.nonzero(~np.isnan(w))
        self.connections[(presynaptic_id, postsynaptic_id)] = (
            src, dst, w[src, dst])
        self._conn_version += 1

    def connect_internally(self, id, connecting_conditional, weight_logic=None):
        self.lattices[id].connect(connecting_conditional, weight_logic)
        self._conn_version += 1

    # -- per-edge access ----------------------------------------------------------
    def _node_of(self, gp):
        """(lattice id, flat index) of an (id, (r, c)) graph position or an
        object with ``.id`` and ``.pos``."""
        if hasattr(gp, "id") and hasattr(gp, "pos"):
            lid, pos = gp.id, tuple(gp.pos)
        else:
            lid, pos = gp[0], tuple(gp[1])
        lat = self.lattices.get(lid) or self.spike_train_lattices.get(lid)
        if lat is None:
            raise LatticeNetworkError(f"unknown lattice id {lid}")
        r, c = pos
        if not (0 <= r < lat.rows and 0 <= c < lat.cols):
            raise LatticeNetworkError(f"position {pos} not in lattice {lid}")
        return lid, r * lat.cols + c

    def _neuron_lattice(self, lid):
        if lid not in self.lattices:
            raise LatticeNetworkError(f"unknown neuron lattice id {lid}")
        return self.lattices[lid]

    def lookup_weight(self, presynaptic, postsynaptic):
        """Weight of one edge, or None; an edge within one lattice is read
        from that lattice's graph."""
        pre_id, src = self._node_of(presynaptic)
        post_id, dst = self._node_of(postsynaptic)
        if pre_id == post_id:
            return self._neuron_lattice(pre_id).graph.lookup_weight(src, dst)
        conn = self.connections.get((pre_id, post_id))
        if conn is not None:
            hits = np.nonzero((conn[0] == src) & (conn[1] == dst))[0]
            if len(hits):
                return float(conn[2][hits[0]])
        return None

    def edit_weight(self, presynaptic, postsynaptic, weight):
        """Set, or with None remove, one edge."""
        pre_id, src = self._node_of(presynaptic)
        post_id, dst = self._node_of(postsynaptic)
        if pre_id == post_id:
            lat = self._neuron_lattice(pre_id)
            lat.graph = lat.graph.edit_weight(src, dst, weight)
            self._conn_version += 1
            return
        s, d, w = self.connections.get((pre_id, post_id),
                                       (np.zeros(0, np.int64),
                                        np.zeros(0, np.int64),
                                        np.zeros(0, np.float32)))
        hits = np.nonzero((s == src) & (d == dst))[0]
        if weight is None:
            if len(hits):
                keep = np.ones(len(s), bool)
                keep[hits[0]] = False
                self.connections[(pre_id, post_id)] = (s[keep], d[keep],
                                                       w[keep])
        elif len(hits):
            w = w.copy()
            w[hits[0]] = weight
            self.connections[(pre_id, post_id)] = (s, d, w)
        else:
            self.connections[(pre_id, post_id)] = (
                np.append(s, src), np.append(d, dst),
                np.append(w, np.float32(weight)))
        self._conn_version += 1

    def get_incoming_connections(self, pos):
        """Every (id, (r, c)) source of ``pos``, across connections and
        within its own lattice's graph."""
        post_id, dst = self._node_of(pos)
        out = set()
        lat = self.lattices.get(post_id)
        if lat is not None and lat.graph is not None:
            for i in lat.graph.get_incoming_connections(dst):
                out.add((post_id, (i // lat.cols, i % lat.cols)))
        for (pre_id, pid), (s, d, w) in self.connections.items():
            if pid != post_id:
                continue
            pre = self.lattices.get(pre_id) \
                or self.spike_train_lattices.get(pre_id)
            for i in s[d == dst]:
                out.add((pre_id, (int(i) // pre.cols, int(i) % pre.cols)))
        return out

    def _plasticity(self):
        for i in sorted(self.lattices):
            if self.lattices[i].do_plasticity:
                return self.lattices[i].plasticity
        return STDP()

    def update(self):
        """One network step."""
        self.run_lattices(1)

    # -- simulation ---------------------------------------------------------------
    def run_lattices(self, iterations):
        """Advance every member ``iterations`` steps, in chunks that bound
        the recorded histories on the device."""
        if iterations == 0:
            return
        if not self.electrical_synapse and not self.chemical_synapse:
            return
        if not (self.structured and type(self) is LatticeNetwork
                and not self.update_connecting_graph_history
                and self.lattices):
            raise NotImplementedError(FLAT_RUNNER_NOT_PORTED)
        any_history = any(l.update_grid_history or l.update_graph_history
                          for l in self.lattices.values()) \
            or any(s.update_grid_history
                   for s in self.spike_train_lattices.values())
        flags = nt_flags(self, resolve_structured_plan(self))
        hchunk = self._history_chunk()
        remaining = iterations
        while remaining > 0:
            chunk = min(remaining, hchunk) if any_history else remaining
            run_structured(self, chunk, flags)
            remaining -= chunk
        write_back_connections(self)

    def _history_chunk(self):
        """Steps per chunk (core/history.resolve_history_chunk), from the
        bytes per step of every recorded readout in the network."""
        bps = 0
        for l in self.lattices.values():
            if l.update_grid_history:
                bps += history_step_bytes(l.grid_history.kind, l.n)
            if l.update_graph_history:
                bps += 4 * int(l.graph.weights.numel())
        for s in self.spike_train_lattices.values():
            if s.update_grid_history:
                bps += history_step_bytes(s.grid_history.kind, s.n)
        return resolve_history_chunk(self.history_chunk, bps)

    def run_lattices_pipelined(self, iterations, mesh=None, order=None):
        raise NotImplementedError(
            MULTI_GPU_NOT_PORTED.format("run_lattices_pipelined"))

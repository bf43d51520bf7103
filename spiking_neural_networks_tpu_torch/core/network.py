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
3. deferred plasticity (STDP or BCM) within and across lattices: an edge
   is updated once per spiking endpoint whose lattice has plasticity on;
4. the clock increments and the member clocks sync;
5. spike-train lattices step last, with the pre-increment clock as their
   firing time.

The network owns one `torch.Generator` on its device, seeded by ``seed``,
from which the Poisson trains draw.

The flat COO runner (`_compile`, `_run_chunk`, `flat_steps`) is the
fallback for what the structured runner does not take, as in the JAX
package: ``update_connecting_graph_history``, a `LatticeNetwork` subclass
and ``structured = False``.  It lowers every member into one global node
space (lattices in id order, then trains) and every intra and connecting
edge into one COO list, and steps that in plain PyTorch: ``index_add_``
gathers, or dense matrix products while the (n_total, n_neurons) matrix
holds at most 8 M entries (``dense_gather``).  It has no kernel.
`shard` splits every member in row blocks over a mesh (the structured
runner then takes its plain route over the blocks,
`parallel.network_sharding`; the flat runner does not shard, so a sharded
network that would take it raises); `run_lattices_pipelined` runs a chain of
lattices one stage per mesh position (`parallel.pipeline`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import LatticeNetworkError
from ..models.base import NEVER, get_neurotransmitter_concentrations
from ..models.spike_train import refractoriness_effect
from ..ops.graph import (DenseGraph, SparseGraph, StencilGraph,
                         exact_matmul, positions)
from .history import (GridVoltageHistory, history_step_bytes,
                      resolve_history_chunk)
from .plasticity import (STDP, RewardModulatedSTDP, rstdp_visit, rule_tensors,
                         stdp_delta)
from .structured import (nt_flags, resolve_structured_plan, run_structured,
                         write_back_connections)
from .sharded import block_info, first_shard, shard_of, sharded_field
# the flat runner's dense gathers: (n_total, n_neurons) entries at most
DENSE_GATHER_MAX = 8_000_000


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


def _edge_history_to_layout(graph, prov, src, dst, w_steps):
    """Per-step flat edge weights (T, E) as a list of T arrays in the
    graph's own weight layout (what ``graph_history`` stores)."""
    kind, extra = prov
    if kind == "sparse":
        return list(w_steps)
    out = np.repeat(graph.weights.cpu().numpy()[None], w_steps.shape[0],
                    axis=0)
    if kind == "dense":
        out[:, src, dst] = w_steps
    elif kind == "stencil":
        out[:, extra[:, 0], extra[:, 1], extra[:, 2]] = w_steps
    else:
        raise TypeError(kind)
    return list(out)


def _write_back_graph(graph, src, dst, w, prov):
    """``graph`` with the flat edge weights ``w`` written into its layout
    (a `SparseGraph` re-sorted stably by destination)."""
    kind, extra = prov
    dev = graph.weights.device
    if kind == "sparse":
        order = np.argsort(dst, kind="stable")
        return SparseGraph(_device_tensor(src[order].astype(np.int64), dev),
                           _device_tensor(dst[order].astype(np.int64), dev),
                           _device_tensor(w[order].astype(np.float32), dev),
                           graph.n_pre, graph.n_post)
    weights = graph.weights.cpu().numpy().copy()
    if kind == "dense":
        weights[src, dst] = w
        return DenseGraph(_device_tensor(weights, dev), graph.mask)
    if kind == "stencil":
        weights[extra[:, 0], extra[:, 1], extra[:, 2]] = w
        return StencilGraph(graph.offsets, _device_tensor(weights, dev),
                            graph.mask, graph.in_deg)
    raise TypeError(kind)


def _device_tensor(x, device):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


class SpikeTrainLattice:
    """A grid of spike-train generators on ``device``; no incoming
    connections allowed.  Poisson trains draw from a `torch.Generator`
    seeded by ``seed`` when they run standalone.  A sharded train
    (`shard`) steps its row blocks from one draw of the whole plane."""

    # whole tensors; while sharded, a view assembled from the blocks
    state = sharded_field("state")
    blocks = property(block_info)

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
        self.mesh = None

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
        """Split the state over ``mesh`` in row blocks
        (`parallel.lattice_sharding`)."""
        from ..parallel.lattice_sharding import shard_lattice
        return shard_lattice(self, mesh, axis)

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
        if shard_of(self) is not None:
            ys = self._shard.run_train_chunk(self, length)
            self.internal_clock += length
            if ys:
                self.grid_history.extend(torch.stack(ys).cpu())
            return
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
    # the flat COO runner's gathers as dense products while they fit
    dense_gather = True

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
        """Row-block sharding of every member (`parallel.shard_network`)."""
        from ..parallel.lattice_sharding import shard_network
        return shard_network(self, mesh, axis)

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
        lattices = self._neuron_lattices()
        if postsynaptic_id not in lattices:
            raise KeyError(f"unknown postsynaptic id {postsynaptic_id}")
        if presynaptic_id == postsynaptic_id:
            return self.connect_internally(
                presynaptic_id, connecting_conditional, weight_logic)
        pre = lattices.get(presynaptic_id) \
            or self.spike_train_lattices.get(presynaptic_id)
        if pre is None:
            raise KeyError(f"unknown presynaptic id {presynaptic_id}")
        post = lattices[postsynaptic_id]
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
        lattices = self._neuron_lattices()
        pre = lattices.get(presynaptic_id) \
            or self.spike_train_lattices.get(presynaptic_id)
        post = lattices[postsynaptic_id]
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
        self._neuron_lattices()[id].connect(connecting_conditional,
                                            weight_logic)
        self._conn_version += 1

    # -- per-edge access ----------------------------------------------------------
    def _node_of(self, gp):
        """(lattice id, flat index) of an (id, (r, c)) graph position or an
        object with ``.id`` and ``.pos``."""
        if hasattr(gp, "id") and hasattr(gp, "pos"):
            lid, pos = gp.id, tuple(gp.pos)
        else:
            lid, pos = gp[0], tuple(gp[1])
        lat = self._neuron_lattices().get(lid) \
            or self.spike_train_lattices.get(lid)
        if lat is None:
            raise LatticeNetworkError(f"unknown lattice id {lid}")
        r, c = pos
        if not (0 <= r < lat.rows and 0 <= c < lat.cols):
            raise LatticeNetworkError(f"position {pos} not in lattice {lid}")
        return lid, r * lat.cols + c

    def _neuron_lattice(self, lid):
        lattices = self._neuron_lattices()
        if lid not in lattices:
            raise LatticeNetworkError(f"unknown neuron lattice id {lid}")
        return lattices[lid]

    def lookup_weight(self, presynaptic, postsynaptic):
        """Weight of one edge, or None; an edge within one lattice is read
        from that lattice's graph, and a reward-modulated connection's
        edge reports its weight too."""
        pre_id, src = self._node_of(presynaptic)
        post_id, dst = self._node_of(postsynaptic)
        if pre_id == post_id:
            return self._neuron_lattice(pre_id).graph.lookup_weight(src, dst)
        for conns in (self.connections,
                      getattr(self, "reward_connections", {})):
            conn = conns.get((pre_id, post_id))
            if conn is not None:
                hits = np.nonzero((conn[0] == src) & (conn[1] == dst))[0]
                if len(hits):
                    return float(conn[2][hits[0]])
        return None

    def edit_weight(self, presynaptic, postsynaptic, weight):
        """Set, or with None remove, one edge.  An edge of a
        reward-modulated connection is edited there, in place (a plain
        duplicate would deliver the synapse twice)."""
        pre_id, src = self._node_of(presynaptic)
        post_id, dst = self._node_of(postsynaptic)
        if pre_id == post_id:
            lat = self._neuron_lattice(pre_id)
            lat.graph = lat.graph.edit_weight(src, dst, weight)
            self._conn_version += 1
            return
        rconns = getattr(self, "reward_connections", {})
        rconn = rconns.get((pre_id, post_id))
        if rconn is not None:
            hits = np.nonzero((rconn[0] == src) & (rconn[1] == dst))[0]
            if len(hits):
                if weight is None:
                    keep = np.ones(len(rconn[0]), bool)
                    keep[hits[0]] = False
                    rconns[(pre_id, post_id)] = tuple(a[keep] for a in rconn)
                else:
                    w = np.asarray(rconn[2]).copy()
                    w[hits[0]] = weight
                    rconns[(pre_id, post_id)] = rconn[:2] + (w,) + rconn[3:]
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
        """Every (id, (r, c)) source of ``pos``, across connections (and
        reward connections) and within its own lattice's graph."""
        post_id, dst = self._node_of(pos)
        out = set()
        lattices = self._neuron_lattices()
        lat = lattices.get(post_id)
        if lat is not None and lat.graph is not None:
            for i in lat.graph.get_incoming_connections(dst):
                out.add((post_id, (i // lat.cols, i % lat.cols)))
        reward = [(k, v[:3]) for k, v in
                  getattr(self, "reward_connections", {}).items()]
        for (pre_id, pid), (s, d, w) in \
                list(self.connections.items()) + reward:
            if pid != post_id:
                continue
            pre = lattices.get(pre_id) \
                or self.spike_train_lattices.get(pre_id)
            for i in s[d == dst]:
                out.add((pre_id, (int(i) // pre.cols, int(i) % pre.cols)))
        return out

    def _neuron_lattices(self):
        """Every neuron-bearing lattice by id (a reward network adds its
        reward-modulated lattices)."""
        return self.lattices

    def _plasticity(self):
        for i in sorted(self.lattices):
            if self.lattices[i].do_plasticity:
                return self.lattices[i].plasticity
        return STDP()

    def update(self):
        """One network step."""
        self.run_lattices(1)

    # -- simulation ---------------------------------------------------------------
    def _structured_supported(self):
        return (type(self) is LatticeNetwork
                and not self.update_connecting_graph_history
                and self.lattices)

    def _any_history(self):
        """Whether any member records a history (the runs then go in
        chunks that bound it on the device)."""
        return any(l.update_grid_history or l.update_graph_history
                   for l in self._neuron_lattices().values()) \
            or any(s.update_grid_history
                   for s in self.spike_train_lattices.values()) \
            or self.update_connecting_graph_history

    def run_lattices(self, iterations):
        """Advance every member ``iterations`` steps, in chunks that bound
        the recorded histories on the device: the structured runner, or
        the flat COO runner where it does not apply."""
        if iterations == 0:
            return
        if not self.electrical_synapse and not self.chemical_synapse:
            return
        hchunk = self._history_chunk() if self._any_history() \
            else iterations
        if self.structured and self._structured_supported():
            flags = nt_flags(self, resolve_structured_plan(self))
            for off in range(0, iterations, hchunk):
                run_structured(self, min(hchunk, iterations - off), flags)
            write_back_connections(self)
            return
        plan = self._compile()
        for off in range(0, iterations, hchunk):
            self._run_chunk(plan, min(hchunk, iterations - off))
        self._write_back(plan)

    def _history_chunk(self):
        """Steps per chunk (core/history.resolve_history_chunk), from the
        bytes per step of every recorded readout in the network."""
        bps = 0
        for l in self._neuron_lattices().values():
            if l.update_grid_history:
                bps += history_step_bytes(l.grid_history.kind, l.n)
            if l.update_graph_history:
                bps += 4 * int(l.graph.weights.numel())
        for s in self.spike_train_lattices.values():
            if s.update_grid_history:
                bps += history_step_bytes(s.grid_history.kind, s.n)
        if self.update_connecting_graph_history:
            bps += 4 * sum(len(c[0]) for c in self.connections.values())
        return resolve_history_chunk(self.history_chunk, bps)

    # -- the flat COO runner ------------------------------------------------------
    def _compile(self):
        """The flat COO plan: node offsets (lattices in id order, then
        trains), every intra edge (with its provenance) and connecting
        edge in one COO list, per-edge and per-node plasticity flags, the
        in-degrees, the concatenated states, and with ``dense_gather`` the
        dense (n_total, n_neurons) weight, mask and plasticity matrices."""
        lattices = self._neuron_lattices()
        if not lattices:
            raise LatticeNetworkError("a network needs at least one "
                                      "lattice to run")
        if first_shard(list(lattices.values())
                       + list(self.spike_train_lattices.values())) \
                is not None:
            # this runner would step every member whole on one device
            raise LatticeNetworkError(
                "a sharded network runs only on the structured runner; a "
                "connecting-graph history, a subclass or structured = "
                "False needs the flat runner, which does not shard")
        dev = self.device
        lat_ids = sorted(lattices)
        st_ids = sorted(self.spike_train_lattices)
        n_offset, st_offset, off = {}, {}, 0
        for i in lat_ids:
            n_offset[i] = off
            off += lattices[i].n
        n_neurons = off
        for i in st_ids:
            st_offset[i] = off
            off += self.spike_train_lattices[i].n
        n_total = off
        srcs, dsts, ws, plastic, provenance = [], [], [], [], []
        for i in lat_ids:
            lat = lattices[i]
            src, dst, w, prov = _graph_to_coo(lat.graph)
            srcs.append(src + n_offset[i])
            dsts.append(dst + n_offset[i])
            ws.append(w)
            plastic.append(np.full(len(w), bool(lat.do_plasticity)))
            provenance.append(("intra", i, len(w), prov, src, dst))
        for (pre_id, post_id), (src, dst, w) in sorted(
                self.connections.items()):
            srcs.append(src + n_offset.get(pre_id, st_offset.get(pre_id)))
            dsts.append(dst + n_offset[post_id])
            ws.append(w)
            # a connecting edge is plastic when either endpoint's lattice
            # is; the per-node flags then give the visit counts
            pre_lat = lattices.get(pre_id)
            plastic.append(np.full(len(w), bool(
                lattices[post_id].do_plasticity
                or (pre_lat is not None and pre_lat.do_plasticity))))
            provenance.append(("connecting", (pre_id, post_id), len(w), None,
                               src, dst))
        src = np.concatenate(srcs).astype(np.int64)
        dst = np.concatenate(dsts).astype(np.int64)
        w = np.concatenate(ws).astype(np.float32)
        plastic = np.concatenate(plastic).astype(bool)
        # a spiking neuron of a plastic lattice triggers a visit of its
        # edges; trains never trigger
        node_plastic = np.zeros(n_total, np.float32)
        for i in lat_ids:
            if lattices[i].do_plasticity:
                node_plastic[n_offset[i]:n_offset[i] + lattices[i].n] = 1.0
        in_deg = np.zeros(n_neurons, np.float32)
        np.add.at(in_deg, dst, 1.0)
        first = lattices[lat_ids[0]]
        nstate = {k: torch.cat([lattices[i].state[k] for i in lat_ids])
                  for k in first.state}
        st_state = None
        if st_ids:
            st0 = self.spike_train_lattices[st_ids[0]]
            st_state = {k: torch.cat([self.spike_train_lattices[i].state[k]
                                      for i in st_ids]) for k in st0.state}
        dense = None
        if self.dense_gather and len(w) \
                and n_total * n_neurons <= DENSE_GATHER_MAX:
            dense = {}
            for name, vals, dtype in (("w", w, np.float32),
                                      ("mask", True, bool),
                                      ("plastic", plastic, bool)):
                m = np.zeros((n_total, n_neurons), dtype)
                m[src, dst] = vals
                dense[name] = _device_tensor(m, dev)
        return dict(
            lat_ids=lat_ids, st_ids=st_ids, n_offset=n_offset,
            st_offset=st_offset, n_neurons=n_neurons, n_total=n_total,
            src=_device_tensor(src, dev), dst=_device_tensor(dst, dev),
            w=_device_tensor(w, dev), plastic=_device_tensor(plastic, dev),
            node_plastic=_device_tensor(node_plastic, dev),
            in_deg=_device_tensor(in_deg, dev), dense=dense, nstate=nstate,
            st_state=st_state, provenance=provenance)

    def _history_signature(self, plan):
        """Per recorded grid history: (("lat" | "st", id), readout, shape,
        offset into the concatenated state, n)."""
        sig = []
        lattices = self._neuron_lattices()
        for i in plan["lat_ids"]:
            lat = lattices[i]
            if lat.update_grid_history:
                sig.append((("lat", i), lat.grid_history, (lat.rows, lat.cols),
                            plan["n_offset"][i], lat.n))
        for i in plan["st_ids"]:
            st = self.spike_train_lattices[i]
            if st.update_grid_history:
                sig.append((("st", i), st.grid_history, (st.rows, st.cols),
                            plan["st_offset"][i] - plan["n_neurons"], st.n))
        return sig

    def _run_chunk(self, plan, length, rewards=None, with_reward=False):
        """``length`` flat steps (`flat_steps`), then the histories: grid
        readouts, the connecting graph's flat weights and per-lattice
        graph histories in their layouts."""
        lattices = self._neuron_lattices()
        ghist, start = [], 0
        for kind, owner, count, prov, src, dst in plan["provenance"]:
            if kind == "intra" and lattices[owner].update_graph_history:
                ghist.append((owner, start, count, prov, src, dst))
            start += count
        hist = self._history_signature(plan)
        ys = flat_steps(self, plan, length, hist,
                        self.update_connecting_graph_history or ghist,
                        rewards, with_reward)
        self.internal_clock += length
        for key, h, _, _, _ in hist:
            h.extend(ys[key].cpu())
        if ghist or self.update_connecting_graph_history:
            w_steps = ys["w"].cpu().numpy()
            if self.update_connecting_graph_history:
                self.connecting_graph_history.extend(list(w_steps))
            for i, start, count, prov, src, dst in ghist:
                lattices[i].graph_history.extend(_edge_history_to_layout(
                    lattices[i].graph, prov, src, dst,
                    w_steps[:, start:start + count]))

    def _write_back(self, plan, n_edges=None):
        """The plan's states, graphs and connection weights back into the
        members (the first ``n_edges`` flat edges; all by default)."""
        lattices = self._neuron_lattices()
        for i in plan["lat_ids"]:
            lat, off = lattices[i], plan["n_offset"][i]
            lat.state = {k: v[off:off + lat.n].clone()
                         for k, v in plan["nstate"].items()}
            lat.internal_clock = self.internal_clock
        for i in plan["st_ids"]:
            st = self.spike_train_lattices[i]
            off = plan["st_offset"][i] - plan["n_neurons"]
            st.state = {k: v[off:off + st.n].clone()
                        for k, v in plan["st_state"].items()}
            st.internal_clock = self.internal_clock
        w = plan["w"].cpu().numpy()[:n_edges]
        offset = 0
        for kind, owner, count, prov, src, dst in plan["provenance"]:
            wslice = w[offset:offset + count]
            if kind == "intra":
                lat = lattices[owner]
                lat.graph = _write_back_graph(lat.graph, src, dst, wslice,
                                              prov)
            else:
                self.connections[owner] = (src, dst, wslice.copy())
                self._conn_version += 1
            offset += count

    def run_lattices_pipelined(self, iterations, mesh=None, order=None):
        """`run_lattices` for a chain of lattices, one stage per mesh
        position (`parallel.pipeline.run_pipelined`)."""
        if iterations == 0:
            return
        from ..parallel.pipeline import run_pipelined
        run_pipelined(self, iterations, mesh=mesh, order=order)


def flat_steps(net, plan, length, hist=(), w_history=False, rewards=None,
               with_reward=False):
    """``length`` plain PyTorch steps of a flat COO ``plan``, updating its
    states, weights (and a reward plan's traces and the network's
    dopamine) in place.  Per step, as the JAX package's flat runners:

    1. phase A, the electrical input ``gap * sum w * (a_src - sub * v) /
       max(in_deg, 1)`` over every edge (a train's source is its effect,
       with no ``v`` subtraction), as ``index_add_`` or dense products;
    2. with ``with_reward``, the dopamine decay and reward;
    3. the chemical gathers (per type, the weighted concentrations of the
       present sources over their count), then the model step, and the
       firing times;
    4. the rule (STDP or BCM, its ``NODE_KEYS`` read at both ends) on
       the plastic edges, one visit per spiking endpoint in a plastic
       lattice (a reward plan: on its plain edges, plus a visit every step
       where one end is a modulated lattice and the other a plain one);
    5. a reward plan's R-STDP: per modulated edge one visit per modulated
       endpoint and per spiking plastic endpoint, at most two, gated;
    6. the clock increments and the trains step last.

    ``hist`` is `LatticeNetwork._history_signature`; ``w_history`` asks for
    the flat weights of every step.  Returns the stacked readouts keyed as
    in ``hist`` and, with ``w_history``, under "w"."""
    lattices = net._neuron_lattices()
    lat_ids, st_ids = plan["lat_ids"], plan["st_ids"]
    model = lattices[lat_ids[0]].model
    st_model = net.spike_train_lattices[st_ids[0]].model if st_ids else None
    reward = "trace" in plan
    plasticity = net._plasticity()
    do_plasticity = any(l.do_plasticity for l in net.lattices.values()) \
        or plan.get("stdp_cross_any", False)
    rule = type(plasticity)
    dev = plan["w"].device
    p = rule_tensors(plasticity.params, dev)
    rp = rule_tensors(net.reward_modulator.params, dev) if reward else None
    n_neurons, n_total = plan["n_neurons"], plan["n_total"]
    src, dst = plan["src"], plan["dst"]
    dense = plan["dense"]
    w = dense["w"] if dense else plan["w"]
    gate = ~plan["modulated"] if reward else plan["plastic"]
    if dense:
        gate = dense["plastic"]
    nstate, st_state = plan["nstate"], plan["st_state"]
    cnt = torch.clamp(plan["in_deg"], min=1.0)
    skip_nt = not bool(nstate["nt$mask"].any())
    node_plastic = plan["node_plastic"][:n_neurons]
    pad = torch.zeros(n_total - n_neurons, dtype=torch.float32, device=dev)
    dopamine = torch.tensor(float(getattr(net, "dopamine", 0.0)),
                            dtype=torch.float32, device=dev)
    if rewards is not None:
        rewards = torch.from_numpy(np.array(rewards, np.float32)).to(dev)
    generator = net.generator()
    clock = net.internal_clock
    ys = {key: [] for key, *_ in hist}
    w_steps = []

    def node_vals(key, spikes):
        """A per-neuron field, the trains' (previous) values appended."""
        nv = spikes if key == "is_spiking" else nstate[key]
        if st_state is None:
            return nv
        return torch.cat([nv, st_state[key] if key in st_state
                          else pad.to(nv.dtype)])

    for k in range(length):
        v = nstate["v"]
        if st_state is not None:
            effect = refractoriness_effect(st_model.refractoriness, st_state,
                                           clock)
            a_src = torch.cat([v, effect])
            sub_v = torch.cat([torch.ones_like(v), torch.zeros_like(effect)])
        else:
            a_src, sub_v = v, torch.ones_like(v)
        if net.electrical_synapse:
            if dense:
                summed = exact_matmul(a_src, w) - v * exact_matmul(sub_v, w)
            else:
                contrib = w * (a_src[src] - sub_v[src] * v[dst])
                summed = torch.zeros_like(v).index_add_(0, dst, contrib)
            elec = nstate["gap_conductance"] * summed / cnt
        else:
            elec = torch.zeros_like(v)
        if with_reward:
            dopamine = RewardModulatedSTDP.update_dopamine(dopamine,
                                                           rewards[k], rp)
        if net.chemical_synapse:
            t_src, m_src = get_neurotransmitter_concentrations(nstate)
            if st_state is not None:
                t_s, m_s = get_neurotransmitter_concentrations(st_state)
                t_src, m_src = torch.cat([t_src, t_s]), torch.cat([m_src, m_s])
            m_src = m_src.to(torch.float32)
            if dense:
                sums = exact_matmul(w.T, t_src * m_src)
                cnts = exact_matmul(dense["mask"].to(torch.float32).T, m_src)
            else:
                zeros = t_src.new_zeros((n_neurons, t_src.shape[-1]))
                sums = zeros.index_add(0, dst, w[:, None] * t_src[src]
                                       * m_src[src])
                cnts = zeros.index_add(0, dst, m_src[src])
            nstate, spikes = model.step(nstate, elec,
                                        sums / torch.clamp(cnts, min=1.0),
                                        cnts > 0.0, skip_nt=skip_nt)
        else:
            nstate, spikes = model.step(nstate, elec, skip_nt=skip_nt)
        nstate["last_firing_time"] = \
            nstate["last_firing_time"].masked_fill(spikes, clock)
        trig = torch.cat([spikes.to(torch.float32) * node_plastic, pad])
        lft = node_vals("last_firing_time", spikes)
        if do_plasticity:
            vals = {key: node_vals(key, spikes) for key in rule.NODE_KEYS}
            if dense:
                pre = {key: x[:, None] for key, x in vals.items()}
                post = {key: x[None, :n_neurons] for key, x in vals.items()}
                count = trig[:, None] + trig[None, :n_neurons]
            else:
                pre = {key: x[src] for key, x in vals.items()}
                post = {key: x[dst] for key, x in vals.items()}
                count = trig[src] + trig[dst]
            if reward:
                mod, plain = plan["node_mod"], plan["node_plain"]
                count = count + mod[src] * plain[dst] + mod[dst] * plain[src]
            w = torch.where(gate, rule.apply_visits(w, pre, post, p, count),
                            w)
        if reward:
            mod = plan["node_mod"]
            visits = torch.where(plan["modulated"],
                                 mod[src] + mod[dst] + trig[src] + trig[dst],
                                 0.0)
            delta = stdp_delta(lft[src], lft[dst], rp)
            tr = plan["trace"]
            c, dw, ct = tr["c"], tr["dw"], tr["counter"]
            for n_visit in (1.0, 2.0):
                w1, c1, d1, t1 = rstdp_visit(w, c, dw, ct, delta, dopamine,
                                             rp)
                m = visits >= n_visit
                w, c = torch.where(m, w1, w), torch.where(m, c1, c)
                dw, ct = torch.where(m, d1, dw), torch.where(m, t1, ct)
            plan["trace"] = dict(c=c, dw=dw, counter=ct)
        clock += 1
        if st_state is not None:
            st_state, st_spikes = st_model.step(st_state, generator,
                                                clock - 1)
            st_state["last_firing_time"] = \
                st_state["last_firing_time"].masked_fill(st_spikes,
                                                         clock - 1)
        for key, h, shape, off, n in hist:
            state = nstate if key[0] == "lat" else st_state
            ys[key].append(h.readout({"v": state["v"][off:off + n],
                                      "is_spiking":
                                          state["is_spiking"][off:off + n]},
                                     shape))
        if w_history:
            w_steps.append(w[src, dst] if dense else w)
    plan["nstate"], plan["st_state"] = nstate, st_state
    if dense:
        dense["w"] = w
        plan["w"] = w[src, dst]
    else:
        plan["w"] = w
    if reward:
        net.dopamine = float(dopamine)
    out = {key: torch.stack(y) for key, y in ys.items()}
    if w_history:
        out["w"] = torch.stack(w_steps)
    return out

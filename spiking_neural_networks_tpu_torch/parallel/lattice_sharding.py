"""Shard one lattice's state and graph over a mesh, in row blocks.

PyTorch counterpart of ``spiking_neural_networks_tpu/parallel/
lattice_sharding.py``.  There the partitioner derives the halo exchange
from `NamedSharding` placements; here each mesh position holds a block of
its own, and the runners exchange the rows a block reads from its
neighbours:

* a lattice of ``rows`` rows over a mesh of ``P`` positions (the mesh
  flattened row-major) gives position ``p`` the owned rows
  ``[p * rows / P, (p + 1) * rows / P)`` on its device;
* on a `StencilGraph` a block also holds ``g`` ghost rows on each side
  that has a neighbour (none past the lattice's top and bottom edges, so
  the plain gather's zero pad and the kernels' bounds check see exactly
  the global edge): its state leaves, weight, mask and in-degree planes
  and R-STDP trace planes cover the extended rows.  The runners refresh
  the ghost rows from their owners, step every block on its extended
  rows, and throw the ghost rows' results away (overlap-and-discard).
  Influence travels at most ``halo = max |dr|`` rows a step, so after
  ``K`` steps on ``g = halo * K`` ghost rows the owned rows equal the
  unsharded run's bit for bit: the stencil kernel route refreshes v and
  w once per K-step `stencil_kernels.StencilRun` call (the sharded
  composition),
  the plain route every step with ``g = halo``, or ``2 * halo`` where a
  rule reads the neighbours' post-step firing times;
* a `DenseGraph` is split on its post (column) axis: a block owns its
  neurons' columns and reads the presynaptic vector assembled from every
  block (an all-gather) through `ops.graph.exact_matmul`;
* a `SparseGraph`'s COO list is split by destination when `shard` is
  called: a block keeps the edges into its neurons, in their order;
* a spike-train lattice's blocks step their own rows; a Poisson train
  draws the whole plane from its one generator and keeps its rows.

Rows that the mesh size does not divide leave the lattice unsharded, as
in the JAX package (its ``mesh`` is still recorded).  ``lat.state``,
``lat.graph`` and ``lat.trace`` stay readable as whole tensors on the
first block's device: an assembled view, rebuilt after each run; setting
one (``apply``, ``connect_stencil``, ``lat.state = ...``) or changing a
view's tensors re-shards at the next run.  ``lat.blocks`` lists each
block's position, device, rank and rows.

Blocks on one device (virtual shards) exchange rows by device copies;
blocks on different devices by `Tensor.copy_` across devices (each
block's kernels launch under its own device, `model_kernels.RunSets`);
blocks of different processes by `torch.distributed.batch_isend_irecv`
(stencil graphs only).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.graph import DenseGraph, SparseGraph, StencilGraph
from .mesh import Mesh, current_rank, device_array

# the kernel route's steps a ghost refresh, largest first (as the JAX
# package's sharded_multistep_config)
KERNEL_STEPS = (16, 8, 4, 2, 1)


def make_lattice_mesh(n_devices=None, devices=None, axis="tp"):
    """A 1-D mesh over the row axis, by default over the visible CUDA
    devices.  Raises when fewer devices exist than ``n_devices``: a mesh
    of CPU or repeated devices (virtual shards) is taken only where the
    caller names it, e.g. ``devices=[torch.device("cpu")] * 8`` (a silent
    CPU substitution would make a GPU run quietly run on the host)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("no CUDA device: name the mesh's devices, e.g. "
                         "devices=[torch.device('cpu')] * 8")
    return Mesh(device_array(devices), (axis,))


def stencil_halo(offsets):
    """The rows a stencil reaches: its largest |dr| (0 without offsets)."""
    return max([abs(dr) for dr, _ in offsets], default=0)


def sharded_kernel_config(offsets, block_rows):
    """``(K, g)`` of the sharded kernel route: the largest K of
    `KERNEL_STEPS` whose ``g = halo * K`` ghost rows fit in one
    neighbour's ``block_rows`` (the ghost rows come from the adjacent
    block alone)."""
    halo = stencil_halo(offsets)
    for k in KERNEL_STEPS:
        if halo * k <= block_rows:
            return k, halo * k
    return None


def state_spec(mesh, n, leaf, axis="tp", rows=None):
    """``"rows"`` where an (N, ...) state leaf is split in row blocks over
    the mesh (``rows``, or N, divisible by its size), else
    ``"replicated"``."""
    divisible = (rows % mesh.size == 0) if rows else (n % mesh.size == 0)
    if isinstance(leaf, torch.Tensor) and leaf.dim() >= 1 \
            and leaf.shape[0] == n and divisible:
        return "rows"
    return "replicated"


class BlockInfo(NamedTuple):
    """A block's mesh position, device, owning rank (None: this process
    on a one-process mesh), owned rows ``[lo, hi)`` and extended rows
    (ghost rows included)."""
    position: int
    device: torch.device
    rank: object
    rows: tuple
    ext: tuple


class _Block:
    """One position's block: its rows, and on the owning process its
    state, graph, trace and (sparse graphs) the indices of its edges in
    the whole edge list."""

    def __init__(self, position, device, rank, own, ext):
        self.position, self.device, self.rank = position, device, rank
        self.own, self.ext = own, ext
        self.state = self.graph = self.trace = self.edges = None

    @property
    def n_rows(self):
        return self.ext[1] - self.ext[0]

    def local_rows(self, r0, r1):
        return slice(r0 - self.ext[0], r1 - self.ext[0])

    @property
    def owned(self):
        return self.local_rows(*self.own)


def _row_view(t, kind, cols):
    """A view of ``t`` with the grid rows on its first axis: a flat state
    leaf (N, ...) (``leaf``), a (rows, cols) plane (``grid``) or an
    (n_off, rows, cols) plane stack (``plane``)."""
    if kind == "leaf":
        return t.view(t.shape[0] // cols, cols, *t.shape[1:])
    if kind == "plane":
        return t.transpose(0, 1)
    return t


def _wire(t):
    """``t`` as the collectives send it: contiguous, bool as uint8."""
    return (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()


def _sig(obj):
    """What a view was built from: the identity and in-place version of
    each tensor (a dict's items, a graph's attributes)."""
    if obj is None:
        return None
    items = obj.items() if isinstance(obj, dict) else vars(obj).items()
    return (id(obj),) + tuple(
        (k, id(v), v._version) for k, v in sorted(items, key=lambda kv: kv[0])
        if isinstance(v, torch.Tensor))


# the signature of a view the user set: equal to no `_sig`
_SET = "set"


def _is_leaf(x, n):
    return isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == n


class RowBlocks:
    """The blocks of a ``rows`` x ``cols`` lattice over ``mesh``, with
    ``ghost`` ghost rows (stencil graphs), the ghost refresh and the
    assembly of owned rows."""

    def __init__(self, mesh, rows, cols, ghost):
        self.mesh, self.rows, self.cols, self.ghost = mesh, rows, cols, ghost
        positions = mesh.positions()
        step = rows // len(positions)
        self.multi = mesh.spans_processes()
        me = current_rank()
        self.blocks = []
        for p, (dev, rank) in enumerate(positions):
            lo, hi = p * step, (p + 1) * step
            blk = _Block(p, dev, rank, (lo, hi),
                         (max(lo - ghost, 0), min(hi + ghost, rows)))
            blk.is_local = rank is None or rank == me
            self.blocks.append(blk)
        if self.multi:
            owners = [b.rank for b in self.blocks]
            if owners != sorted(owners) or len(set(
                    owners.count(r) for r in owners)) != 1:
                raise ValueError("a mesh across processes needs each "
                                 "process's positions contiguous and equal "
                                 "in number (make_hybrid_mesh's order)")
        # (block, owner, r0, r1): global rows [r0, r1) of block's ghost
        # rows that block ``owner`` owns
        self.transfers = []
        for b in self.blocks:
            for a, c in ((b.ext[0], b.own[0]), (b.own[1], b.ext[1])):
                for j in self.blocks:
                    r0, r1 = max(a, j.own[0]), min(c, j.own[1])
                    if r0 < r1:
                        self.transfers.append((b, j, r0, r1))

    @property
    def local(self):
        return [b for b in self.blocks if b.is_local]

    @property
    def first_device(self):
        return self.local[0].device

    def info(self):
        return [BlockInfo(b.position, b.device, b.rank, b.own, b.ext)
                for b in self.blocks]

    def refresh(self, fetch):
        """Write every local block's ghost rows from their owners.
        ``fetch(block)`` lists the block's tensors as ``(tensor, kind)``
        pairs (`_row_view` kinds), in one order on every block and
        process; the ghost rows are written in place."""
        if not self.transfers:
            return
        got = {b.position: fetch(b) for b in self.local}
        n_t = len(next(iter(got.values())))
        ops, pending, tag = [], [], 0
        import torch.distributed as dist
        for b, j, r0, r1 in self.transfers:
            for t in range(n_t):
                tag += 1
                dst = src = None
                if b.is_local:
                    x, kind = got[b.position][t]
                    dst = _row_view(x, kind, self.cols)[b.local_rows(r0, r1)]
                if j.is_local:
                    x, kind = got[j.position][t]
                    src = _row_view(x, kind, self.cols)[j.local_rows(r0, r1)]
                if dst is not None and src is not None:
                    dst.copy_(src)
                elif src is not None:
                    ops.append(dist.P2POp(dist.isend, _wire(src), b.rank,
                                          tag=tag))
                elif dst is not None:
                    buf = torch.empty(dst.shape, device=dst.device,
                                      dtype=torch.uint8
                                      if dst.dtype == torch.bool
                                      else dst.dtype)
                    ops.append(dist.P2POp(dist.irecv, buf, j.rank, tag=tag))
                    pending.append((dst, buf))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for dst, buf in pending:
            dst.copy_(buf)

    def assemble(self, pieces, device, dim=0):
        """The local blocks' ``pieces`` (by position, in position order)
        concatenated along ``dim`` on ``device``; across processes every
        process's pieces, in rank order (a collective: every process
        calls it)."""
        local = torch.cat([pieces[b.position].to(device) for b in self.local],
                          dim=dim)
        if not self.multi:
            return local
        import torch.distributed as dist
        x = _wire(local.movedim(dim, 0))
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x)
        out = torch.cat(parts).to(local.dtype).movedim(0, dim)
        return out.contiguous()


def shard_state(state, mesh, n, axis="tp", rows=None, ghost=0):
    """Per-position state dicts of ``state`` (a lattice's flat leaves) on
    each position's device: the (N, ...) leaves cut to the position's
    rows (with ``ghost`` ghost rows), the rest replicated; None at the
    positions of other processes.  Unsplittable rows: the state itself."""
    if not rows or rows % mesh.size:
        return state
    geom = RowBlocks(mesh, rows, n // rows, ghost)
    return [_cut_state(state, b, n, geom.cols) if b.is_local else None
            for b in geom.blocks]


def _copy(x, device):
    return x.to(device, copy=True).contiguous()


def _cut_state(state, b, n, cols):
    lo, hi = b.ext[0] * cols, b.ext[1] * cols
    return {k: _copy(v[lo:hi] if _is_leaf(v, n) else v, b.device)
            for k, v in state.items()}


def _cut_graph(graph, b, cols):
    """Block ``b``'s part of a lattice graph, and (sparse) the indices of
    its edges in the whole list."""
    if isinstance(graph, StencilGraph):
        lo, hi = b.ext
        return StencilGraph(graph.offsets, _copy(graph.weights[:, lo:hi],
                                                 b.device),
                            _copy(graph.mask[:, lo:hi], b.device),
                            _copy(graph.in_deg[lo:hi], b.device)), None
    lo, hi = b.own[0] * cols, b.own[1] * cols
    if isinstance(graph, DenseGraph):
        return DenseGraph(_copy(graph.weights[:, lo:hi], b.device),
                          _copy(graph.mask[:, lo:hi], b.device)), None
    if isinstance(graph, SparseGraph):
        idx = torch.nonzero((graph.dst >= lo) & (graph.dst < hi)).reshape(-1)
        return SparseGraph(_copy(graph.src[idx], b.device),
                           _copy(graph.dst[idx] - lo, b.device),
                           _copy(graph.weights[idx], b.device), graph.n_pre,
                           hi - lo, _copy(graph.in_deg[lo:hi], b.device)), idx
    raise TypeError(f"cannot shard a {type(graph).__name__}")


def _cut_edges(x, graph, b, cols, idx):
    """Block ``b``'s part of an edge array shaped like ``graph.weights``
    (a trace plane)."""
    if isinstance(graph, StencilGraph):
        return _copy(x[:, b.ext[0]:b.ext[1]], b.device)
    if isinstance(graph, DenseGraph):
        return _copy(x[:, b.own[0] * cols:b.own[1] * cols], b.device)
    return _copy(x[idx], b.device)


def shard_graph(graph, mesh, axis="tp", ghost=0):
    """Per-position parts of a lattice graph: a `StencilGraph`'s rows
    (with ``ghost`` ghost rows), a `DenseGraph`'s post columns, a
    `SparseGraph`'s edges by destination; None at the positions of other
    processes.  Rows the mesh size does not divide: the graph itself."""
    rows = graph.shape[0] if isinstance(graph, StencilGraph) else None
    n = graph.n_post
    if rows is None:
        if n % mesh.size:
            return graph
        rows, cols = mesh.size, n // mesh.size
    elif rows % mesh.size:
        return graph
    else:
        cols = n // rows
    geom = RowBlocks(mesh, rows, cols, ghost)
    return [_cut_graph(graph, b, cols)[0] if b.is_local else None
            for b in geom.blocks]


class LatticeShards:
    """A sharded lattice's blocks and its runners.  ``fields`` names the
    lattice's sharded attributes (``state``, and ``graph`` / ``trace``
    where it has them)."""

    def __init__(self, lat, mesh, fields):
        self.mesh, self.fields = mesh, fields
        self.rows, self.cols, self.n = lat.rows, lat.cols, lat.n
        # the whole values blocks are built from / assembled into, with
        # the signature of what each was built from or assembled as
        self.views = {f: lat.__dict__.get("_" + f) for f in fields}
        self.sigs = {f: _SET for f in fields}
        self.geom = None
        graph = self.views.get("graph")
        if self.mesh.spans_processes() and graph is not None \
                and not isinstance(graph, StencilGraph):
            raise ValueError("a lattice sharded across processes needs a "
                             "StencilGraph (connect_stencil)")

    def __getstate__(self):
        # a copy makes its own kernel runs (their ctypes arguments do not
        # copy)
        return dict(self.__dict__, kernel_runs={})

    # -- the whole-lattice views ------------------------------------------------
    def view(self, name):
        if name not in self.views:
            value = getattr(self, "_assemble_" + name)()
            self.views[name] = value
            self.sigs[name] = _sig(value)
        return self.views[name]

    def set(self, name, value):
        for f in self.fields:
            self.view(f)
        self.views[name] = value
        self.sigs[name] = _SET
        self.geom = None

    def info(self, lat):
        self.sync(lat)
        return self.geom.info()

    # -- the structured network runners' plain route over sharded members
    @staticmethod
    def network_steps(*args):
        from .network_sharding import sharded_plain_steps
        return sharded_plain_steps(*args)

    @staticmethod
    def reward_network_steps(*args):
        from .network_sharding import sharded_reward_steps
        return sharded_reward_steps(*args)

    def done(self):
        """After a run: the blocks changed, so every view is stale."""
        self.views, self.sigs = {}, {}

    def sync(self, lat, ghost=None):
        """Build the blocks (with ``ghost`` ghost rows; by default the
        plain route's) where there are none, where a view was set or its
        tensors changed since it was built or assembled, or where the
        ghost depth differs."""
        changed = any(self.sigs[f] != _sig(v) for f, v in self.views.items())
        if self.geom is not None and not changed \
                and ghost in (None, self.geom.ghost):
            return
        whole = {f: self.view(f) for f in self.fields}
        graph = whole.get("graph")
        if ghost is None:
            ghost = self.plain_ghost(lat, graph)
        if not isinstance(graph, StencilGraph):
            ghost = 0
        if lat.rows % self.mesh.size:
            raise ValueError(f"{lat.rows} rows do not split over "
                             f"{self.mesh.size} positions: unshard first")
        self.rows, self.cols, self.n = lat.rows, lat.cols, lat.n
        self.leaf_keys = {k for k, v in whole["state"].items()
                          if _is_leaf(v, self.n)}
        self.geom = RowBlocks(self.mesh, self.rows, self.cols, ghost)
        # each block's `StencilRun` of the kernel route, kept across chunks
        self.kernel_runs = {}
        for b in self.geom.local:
            b.state = _cut_state(whole["state"], b, self.n, self.cols)
            if graph is not None:
                b.graph, b.edges = _cut_graph(graph, b, self.cols)
            if whole.get("trace") is not None:
                b.trace = {k: _cut_edges(v, graph, b, self.cols, b.edges)
                           for k, v in whole["trace"].items()}
        if isinstance(graph, SparseGraph):
            self.sparse = graph
        self.done()

    def _owned(self, b, x):
        return _row_view(x, "leaf", self.cols)[b.owned]

    def _leaf(self, key, device=None):
        """The whole (N, ...) leaf ``key`` assembled from the blocks."""
        g = self.geom
        device = device or g.first_device
        x = g.assemble({b.position: self._owned(b, b.state[key])
                        for b in g.local}, device)
        return x.reshape((self.n,) + tuple(x.shape[2:]))

    def _assemble_state(self):
        first = self.geom.local[0].state
        return {k: self._leaf(k) if k in self.leaf_keys
                else v.to(self.geom.first_device) for k, v in first.items()}

    def _edges(self, get):
        """An edge array (the weights, or a trace plane ``get`` reads from
        each block) assembled into the whole graph's layout."""
        g, dev = self.geom, self.geom.first_device
        b0 = g.local[0]
        if isinstance(b0.graph, StencilGraph):
            return g.assemble({b.position: get(b)[:, b.owned]
                               for b in g.local}, dev, dim=1)
        if isinstance(b0.graph, DenseGraph):
            return g.assemble({b.position: get(b) for b in g.local}, dev,
                              dim=1)
        x0 = get(b0)
        out = torch.zeros(len(self.sparse.src), dtype=x0.dtype, device=dev)
        for b in g.local:
            out[b.edges.to(dev)] = get(b).to(dev)
        return out

    def _assemble_graph(self):
        g, dev = self.geom, self.geom.first_device
        b0 = g.local[0]
        w = self._edges(lambda b: b.graph.weights)
        if isinstance(b0.graph, StencilGraph):
            return StencilGraph(
                b0.graph.offsets, w,
                self._edges(lambda b: b.graph.mask),
                g.assemble({b.position: b.graph.in_deg[b.owned]
                            for b in g.local}, dev))
        if isinstance(b0.graph, DenseGraph):
            return DenseGraph(w, self._edges(lambda b: b.graph.mask))
        sp = self.sparse
        return SparseGraph(sp.src, sp.dst, w, sp.n_pre, sp.n_post, sp.in_deg)

    def _assemble_trace(self):
        b0 = self.geom.local[0]
        if b0.trace is None:
            return None
        return {k: self._edges(lambda b, k=k: b.trace[k]) for k in b0.trace}

    # -- the runs -----------------------------------------------------------------
    @staticmethod
    def plain_ghost(lat, graph):
        """The plain route's ghost rows: the stencil's reach, twice where
        a rule reads the neighbours' post-step firing times."""
        if not isinstance(graph, StencilGraph):
            return 0
        rule = getattr(lat, "do_plasticity", False) \
            or getattr(lat, "do_modulation", False)
        return stencil_halo(graph.offsets) * (2 if rule else 1)

    def _refresh_state(self, extra=()):
        """Refresh every per-neuron leaf (and ``extra`` edge planes:
        ``"weights"``, ``"trace"``) of every block."""
        if not self.geom.transfers:
            return

        def fetch(b):
            out = [(b.state[k], "leaf") for k in sorted(self.leaf_keys)]
            if "weights" in extra:
                out.append((b.graph.weights, "plane"))
            if "trace" in extra:
                out += [(b.trace[k], "plane") for k in sorted(b.trace)]
            return out
        self.geom.refresh(fetch)

    def _readouts(self, readouts, parts):
        """Each history's readout of the assembled v and spikes (what
        every history kind reads)."""
        if not readouts:
            return
        fields = {"v": self._leaf("v"), "is_spiking": self._leaf("is_spiking")}
        for name, h in readouts:
            parts[name].append(h.readout(fields, (self.rows, self.cols)))

    def kernel_config(self, lat, skip_nt, on_card=None):
        """``(K, g)`` of the sharded kernel route of a `Lattice`'s next
        chunk, or None for the plain route per block: where the unsharded
        lattice would take the stencil kernel (`Lattice._kernel_route`'s
        "kernel": electrical Izhikevich, no plasticity, no
        neurotransmitter) and no history is on.  ``on_card`` (by default,
        whether the blocks are on a CUDA device) decides
        ``use_kernel=None``."""
        from ..ops import stencil_kernels
        self.sync(lat)
        b0 = self.geom.local[0]
        if on_card is None:
            on_card = b0.device.type == "cuda"
        if lat.use_kernel is False or (lat.use_kernel is None
                                       and not on_card) \
                or not skip_nt or lat._history_items() \
                or lat.update_graph_history \
                or not stencil_kernels.supports(
                    lat.model, b0.graph, lat.electrical_synapse,
                    lat.chemical_synapse, lat.do_plasticity):
            return None
        return sharded_kernel_config(b0.graph.offsets,
                                     self.rows // self.mesh.size)

    def skip_nt(self, lat):
        """Whether no block has a neurotransmitter inserted (across
        processes, no block of any: every process takes one route)."""
        self.sync(lat)
        found = torch.tensor(float(any(bool(b.state["nt$mask"].any())
                                       for b in self.geom.local)))
        if self.geom.multi:
            import torch.distributed as dist
            dev = self.geom.first_device
            found = found.to(dev)
            dist.all_reduce(found, op=dist.ReduceOp.MAX)
        return not bool(found)

    def run_lattice_chunk(self, lat, length):
        """``length`` steps of a sharded `Lattice`; returns the stacked
        history readouts by name (and ``__weights__``)."""
        skip_nt = self.skip_nt(lat)
        cfg = self.kernel_config(lat, skip_nt)
        if cfg is not None:
            self.sync(lat, cfg[1])
            designs = self._run_kernel(lat, length, cfg[0])
            lat._last_run_fused = ("sharded", designs) + cfg
            ys = {}
        else:
            self.sync(lat)
            lat._last_run_fused = False
            ys = self._run_plain(lat, length, lat._history_items(), skip_nt)
        self.done()
        return ys

    def _run_kernel(self, lat, length, k_steps):
        """The sharded composition: per K-step call, a ghost refresh of v
        and w from the rows the block's neighbours own (the parameter
        planes' ghost rows never change on this route, and no cell reads
        a ghost row's firing time or spike flag), then one
        `stencil_kernels.StencilRun` call per block on its extended rows.
        A block keeps its `StencilRun` (its checks, route and buffer sets)
        for the next chunk while its state is the one that run left.
        Returns the blocks' designs."""
        from ..ops import stencil_kernels as sk
        g = self.geom
        runs, cur = {}, {}
        for b in g.local:
            st, shape = b.state, (b.n_rows, self.cols)
            cur[b.position] = tuple(st[k].view(shape) for k in
                                    ("v", "w", "last_firing_time"))
            kept = self.kernel_runs.get(b.position)
            if kept is not None and kept[1] is st and kept[2] is b.graph \
                    and kept[3] == _sig(st):
                runs[b.position] = kept[0]
                continue
            runs[b.position] = sk.StencilRun(
                *cur[b.position], b.graph.weights, b.graph.in_deg,
                {k: st[k].view(shape) for k in sk.PARAM_ORDER},
                b.graph.offsets)
        clock, done, spikes = lat.internal_clock, 0, {}
        while done < length:
            n = min(k_steps, length - done)
            g.refresh(lambda b: [(x, "grid") for x in cur[b.position][:2]])
            for b in g.local:
                v, w, lft, spk, _ = runs[b.position].steps(clock, n)
                cur[b.position], spikes[b.position] = (v, w, lft), spk
            clock += n
            done += n
        for b in g.local:
            v, w, lft = cur[b.position]
            st = dict(b.state)
            st["v"], st["w"] = v.reshape(-1), w.reshape(-1)
            st["last_firing_time"] = lft.reshape(-1)
            st["is_spiking"] = spikes[b.position].reshape(-1)
            b.state = st
            self.kernel_runs[b.position] = (runs[b.position], st, b.graph,
                                            _sig(st))
        return tuple(runs[b.position].design for b in g.local)

    def _run_plain(self, lat, length, readouts, skip_nt):
        """The sharded plain route of a `Lattice`: per step a ghost
        refresh, then `core.lattice.lattice_step` on every block (stencil
        graphs), or the column step (dense and sparse graphs)."""
        from ..core.lattice import lattice_step
        from ..core.plasticity import rule_tensors
        g = self.geom
        parts = {name: [] for name, _ in readouts}
        weights = lat.update_graph_history
        if weights:
            parts["__weights__"] = []
        pp = {b.position: rule_tensors(lat.plasticity.params, b.device)
              for b in g.local}
        stencil = isinstance(g.local[0].graph, StencilGraph)
        extra = ("weights",) if lat.do_plasticity else ()
        clock = lat.internal_clock
        for _ in range(length):
            if stencil:
                self._refresh_state(extra)
                for b in g.local:
                    b.state, b.graph, _ = lattice_step(
                        lat.model, lat.electrical_synapse,
                        lat.chemical_synapse, lat.do_plasticity, skip_nt,
                        lat.plasticity, pp[b.position], b.state, b.graph,
                        clock)
            else:
                self._column_step(lat, skip_nt, pp, clock)
            clock += 1
            self._readouts(readouts, parts)
            if weights:
                parts["__weights__"].append(
                    self._edges(lambda b: b.graph.weights))
        return {name: torch.stack(p) for name, p in parts.items()}

    def _full(self, keys):
        """The whole leaves ``keys``, assembled, on each local block's
        device."""
        whole = {k: self._leaf(k) for k in keys}
        return {b.position: {k: v.to(b.device) for k, v in whole.items()}
                for b in self.geom.local}

    def _column_step(self, lat, skip_nt, pp, clock, reward=None):
        """One step of a dense- or sparse-graph lattice's blocks: each
        block's columns read the presynaptic fields assembled from every
        block, its neurons step, then the rule (STDP / BCM, or with
        ``reward`` = ``(rewards_k, dopamine by position, with_reward)``
        the R-STDP visits) updates its columns from the assembled
        post-step fields."""
        from ..core.reward import modulate
        from ..core.plasticity import RewardModulatedSTDP
        from ..models.base import get_neurotransmitter_concentrations
        g = self.geom
        keys = ["v"]
        if lat.chemical_synapse:
            keys += [k for k in g.local[0].state if k.startswith("nt$")]
        pre = self._full(keys)
        for b in g.local:
            s, gr, full = b.state, b.graph, pre[b.position]
            if lat.electrical_synapse:
                elec = gr.gather_electrical(full["v"],
                                            torch.ones_like(full["v"]),
                                            s["v"], s["gap_conductance"])
            else:
                elec = torch.zeros_like(s["v"])
            if reward is not None and reward[2]:
                reward[1][b.position] = RewardModulatedSTDP.update_dopamine(
                    reward[1][b.position], reward[0].to(b.device),
                    pp[b.position])
            if lat.chemical_synapse:
                t, m = get_neurotransmitter_concentrations(full)
                t_in, valid = gr.gather_chemical(t, m.to(torch.float32))
                s, spk = lat.model.step(s, elec, t_in, valid,
                                        skip_nt=skip_nt)
            else:
                s, spk = lat.model.step(s, elec, skip_nt=skip_nt)
            s["last_firing_time"] = s["last_firing_time"].masked_fill(spk,
                                                                      clock)
            b.state = s
        if reward is not None:
            if not lat.do_modulation:
                return
            post = self._full(["last_firing_time"])
            for b in g.local:
                vals = {"last_firing_time": b.state["last_firing_time"]}
                b.graph, b.trace = modulate(
                    b.graph, b.trace, post[b.position], vals,
                    reward[1][b.position], pp[b.position])
            return
        if not lat.do_plasticity:
            return
        rule = lat.plasticity
        keys = list(getattr(rule, "NODE_KEYS",
                            ("last_firing_time", "is_spiking")))
        post = self._full(keys)
        for b in g.local:
            b.graph = b.graph.apply_edge_update(
                lambda w, pr, po, p=pp[b.position]: rule.edge_dw(w, pr, po, p),
                post[b.position], {k: b.state[k] for k in keys})

    def run_reward(self, lat, rewards, with_reward):
        """The sharded plain route of a `RewardModulatedLattice`: per step
        a ghost refresh (state, and with modulation the weight and trace
        planes), then `core.reward.reward_lattice_step` on every block;
        each block keeps its copy of the dopamine, all equal."""
        from ..core.plasticity import rule_tensors
        from ..core.reward import reward_lattice_step
        skip_nt = self.skip_nt(lat)
        self.sync(lat)
        g = self.geom
        pp = {b.position: rule_tensors(lat.reward_modulator.params, b.device)
              for b in g.local}
        dop = {b.position: torch.tensor(lat.dopamine, dtype=torch.float32,
                                        device=b.device) for b in g.local}
        stencil = isinstance(g.local[0].graph, StencilGraph)
        extra = ("weights", "trace") if lat.do_modulation else ()
        readouts = (("grid", lat.grid_history),) \
            if lat.update_grid_history else ()
        parts, weights = {"grid": []}, []
        clock = lat.internal_clock
        for reward in torch.from_numpy(np.array(rewards, np.float32)):
            if stencil:
                self._refresh_state(extra)
                for b in g.local:
                    b.state, b.graph, b.trace, dop[b.position], _ = \
                        reward_lattice_step(
                            lat.model, lat.electrical_synapse,
                            lat.chemical_synapse, lat.do_modulation,
                            with_reward, skip_nt, pp[b.position], b.state,
                            b.graph, b.trace, dop[b.position], clock,
                            reward.to(b.device))
            else:
                self._column_step(lat, skip_nt, pp, clock,
                                  (reward, dop, with_reward))
            clock += 1
            self._readouts(readouts, parts)
            if lat.update_graph_history:
                weights.append(self._edges(lambda b: b.graph.weights))
        lat.dopamine = float(dop[g.local[0].position])
        self.done()
        if parts["grid"]:
            lat.grid_history.extend(torch.stack(parts["grid"]).cpu())
        if weights:
            lat.graph_history.extend(torch.stack(weights).cpu().numpy())

    def run_train_chunk(self, st, length):
        """``length`` steps of a sharded `SpikeTrainLattice`: each block
        steps its rows; a train that draws (Poisson) draws the whole plane
        from the lattice's generator and hands each block its rows, so
        the spikes equal the unsharded run's."""
        self.sync(st)
        g = self.geom
        gen = st.generator()
        readouts = (("grid", st.grid_history),) \
            if st.update_grid_history else ()
        parts, clock = {"grid": []}, st.internal_clock
        for _ in range(length):
            u = torch.rand((self.n,), generator=gen, device=gen.device) \
                if st.model.needs_rng else None
            for b in g.local:
                kw = {} if u is None else {
                    "u": u[b.own[0] * self.cols:b.own[1] * self.cols]
                    .to(b.device)}
                s, spk = st.model.step(b.state, gen, clock, **kw)
                s["last_firing_time"] = s["last_firing_time"].masked_fill(
                    spk, clock)
                b.state = s
            clock += 1
            self._readouts(readouts, parts)
        self.done()
        return parts["grid"]


def shard_lattice(lattice, mesh, axis="tp"):
    """Shard a `Lattice` / `RewardModulatedLattice` / `SpikeTrainLattice`
    over ``mesh`` in row blocks, one a position (a mesh of several axes is
    flattened row-major; ``axis`` is the JAX package's name of the row
    axis).  Call after `populate` / `connect`; calling again re-shards.
    Rows the mesh size does not divide leave it unsharded, with its
    ``mesh`` recorded."""
    fields = tuple(f for f in ("state", "graph", "trace")
                   if isinstance(getattr(type(lattice), f, None), property))
    old = lattice.__dict__.get("_shard")
    if old is not None:
        whole = {f: old.view(f) for f in fields}
        lattice.__dict__["_shard"] = None
        for f, v in whole.items():
            setattr(lattice, f, v)
    lattice.mesh = mesh
    if lattice.state is not None and lattice.rows \
            and lattice.rows % mesh.size == 0:
        sh = LatticeShards(lattice, mesh, fields)
        lattice.__dict__["_shard"] = sh
        sh.sync(lattice)
    return lattice


def unshard_lattice(lattice):
    """Gather a sharded lattice back onto its first block's device as an
    ordinary lattice."""
    sh = lattice.__dict__.get("_shard")
    if sh is not None:
        whole = {f: sh.view(f) for f in sh.fields}
        lattice.__dict__["_shard"] = None
        for f, v in whole.items():
            setattr(lattice, f, v)
    lattice.mesh = None
    return lattice


def shard_network(net, mesh, axis="tp"):
    """Shard every lattice, reward lattice and spike-train lattice of a
    network in row blocks; the structured runner then takes its plain
    route over the blocks (`core.structured`)."""
    for lat in net._neuron_lattices().values():
        shard_lattice(lat, mesh, axis)
    for st in net.spike_train_lattices.values():
        shard_lattice(st, mesh, axis)
    net._conn_version += 1
    net.mesh = mesh
    return net

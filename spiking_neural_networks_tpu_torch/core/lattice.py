"""Single-lattice simulation runtime.

PyTorch counterpart of ``spiking_neural_networks_tpu/core/lattice.py``.  The
cell grid is one flat dict of per-neuron tensors on ``Lattice.device``;
``run_lattice(n)`` is a Python loop on the host in place of ``lax.scan``,
over one of five routes:

* the HH kernel route (`HodgkinHuxley` with chemical synapses on a stencil
  graph, with or without STDP): calls of `ops.hh_kernels.hh_steps`, each
  advancing K = 16 steps;
* the stencil kernel route (electrical Izhikevich, no plasticity): calls
  of one `ops.stencil_kernels.StencilRun` per chunk, each advancing
  K = 16 steps (the CUDA design its route takes on a GPU, the plain twin
  on the CPU);
* the model kernel route (any other model of `ops.model_kernels`' table:
  the integrate-and-fire family, `DopaIzhikevich`, `MorrisLecar`; or a
  neuron of the DSL, through the kernel generated from its step,
  `ops.dsl_kernels`; electrical, no plasticity, no history): calls of one
  `ops.model_kernels.ModelRun` per run, K = 16 steps each;
* the STDP kernel route (Izhikevich, ALIF or LIF with ``do_plasticity``
  and `STDP`): calls of `ops.reward_kernels.lattice_plasticity_steps` of
  kind ``plastic``, K = 16 steps each;
* the plain route: `lattice_step` once per step, in plain PyTorch (the
  gathers in the XLA path's association).

Histories are read on the device per step and copied to the host once per
chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import hh_kernels, model_kernels, reward_kernels, stencil_kernels
from ..ops.graph import (SparseGraph, StencilGraph, connect_auto,
                         radius_offsets)
from .sharded import block_info, shard_of, sharded_field
from ..models.base import NEVER, get_neurotransmitter_concentrations
from .history import (GridVoltageHistory, history_step_bytes,
                      rebuilt_readouts, resolve_history_chunk)
from .plasticity import STDP, rule_tensors
from ..errors import GraphError
from ..utils import profiling

class Lattice:
    """A 2-D grid of one neuron model plus a weighted synapse graph, on
    ``device``.

    ``use_kernel`` picks the route: None (auto) takes a kernel route when
    the state is on a CUDA device and its gate holds: `hh_kernels.supports`
    with no history; else, with no neurotransmitter inserted,
    `stencil_kernels.supports` without plasticity,
    `model_kernels.supports_model` with no history, or
    `reward_kernels.plain_stdp_lattice_spec` with STDP and no graph
    history.  True takes it wherever that gate holds (on the CPU the
    wrapper runs the kernel's plain twin); False always runs
    `lattice_step`.  ``_last_run_fused`` says which route the last chunk
    ran: ``"hh"``, ``("kernel", emit)``, ``"model"``, ``("stdp", emit)``
    or False; after a chunk of a sharded lattice (`shard`) on the
    stencil kernel, ``("sharded", designs, K, g)``.
    """

    # whole tensors; while sharded, views assembled from the blocks
    state = sharded_field("state")
    graph = sharded_field("graph")
    blocks = property(block_info)

    def __init__(self, model, id=0, device="cuda"):
        self.model = model
        self.id = id
        self.device = torch.device(device)
        self.state = None
        self.graph = None
        self.rows = self.cols = 0
        self.electrical_synapse = True
        self.chemical_synapse = False
        self.do_plasticity = False
        self.plasticity = STDP()
        self.update_grid_history = False
        self.grid_history = GridVoltageHistory()
        self.update_graph_history = False
        self.graph_history = []
        self.internal_clock = 0
        # None = auto (history.resolve_history_chunk)
        self.history_chunk = None
        self.use_kernel = None
        self._last_run_fused = False
        self.mesh = None

    # -- construction ---------------------------------------------------------
    @property
    def n(self):
        return self.rows * self.cols

    def populate(self, rows, cols, **overrides):
        """(Re)build the cell grid from the base model on the lattice's
        device; ``overrides`` set fields per neuron (a scalar or an (n,)
        array).  Installs a zero-edge graph."""
        self.rows, self.cols = rows, cols
        self.state = self.model.init_state(rows * cols, device=self.device,
                                           **overrides)
        self.graph = SparseGraph.empty(self.n, device=self.device)

    def connect(self, connecting_conditional, weight_logic=None):
        """Connect every (pre, post) pair of positions for which
        ``connecting_conditional((r1, c1), (r2, c2))`` holds, with weight
        ``weight_logic(pre, post)`` (default 1).  O(N^2) host calls; the
        result is decomposed into a `StencilGraph` on the host where its
        offset support is narrow, and stays a `DenseGraph` where it is
        wide (or there is no edge)."""
        self.graph = connect_auto(self.rows, self.cols, connecting_conditional,
                                  weight_logic, device=self.device)

    def falliable_connect(self, connecting_conditional, weight_logic=None):
        """`connect`; a callable signals failure by raising, which
        propagates."""
        self.connect(connecting_conditional, weight_logic)

    def connect_stencil(self, radius=None, offsets=None, weight_fn=None,
                        keep_prob=1.0, seed=0):
        """Translation-local connectivity as a `StencilGraph` (offsets within
        ``radius``, or the given ``offsets``)."""
        if offsets is None:
            offsets = radius_offsets(radius)
        self.graph = StencilGraph.build(self.rows, self.cols, offsets,
                                        weight_fn=weight_fn,
                                        keep_prob=keep_prob, seed=seed,
                                        device=self.device)

    def set_graph(self, graph):
        if graph.n_post != self.n:
            raise GraphError("graph does not match lattice dimensions")
        self.graph = graph

    def shard(self, mesh, axis="tp"):
        """Split the state and graph over ``mesh`` in row blocks
        (`parallel.lattice_sharding`); call after `populate` / `connect`.
        Runs then step every block: the stencil kernel per block where
        the unsharded lattice would take it without a history (the
        sharded composition), else the plain step per block."""
        from ..parallel.lattice_sharding import shard_lattice
        return shard_lattice(self, mesh, axis)

    # -- per-edge graph access ---------------------------------------------------
    def _flat(self, pos):
        r, c = pos
        if not (0 <= r < self.rows and 0 <= c < self.cols):
            raise GraphError(f"position {pos} not in lattice")
        return r * self.cols + c

    def lookup_weight(self, presynaptic, postsynaptic):
        """Weight of the synapse pre -> post, or None if unconnected;
        positions are (row, col) tuples."""
        return self.graph.lookup_weight(self._flat(presynaptic),
                                        self._flat(postsynaptic))

    def edit_weight(self, presynaptic, postsynaptic, weight):
        """Set, or with None remove, one synapse."""
        self.graph = self.graph.edit_weight(self._flat(presynaptic),
                                            self._flat(postsynaptic), weight)

    def get_incoming_connections(self, pos):
        """The presynaptic (row, col) positions of ``pos``."""
        flat = self.graph.get_incoming_connections(self._flat(pos))
        return {(i // self.cols, i % self.cols) for i in flat}

    def get_outgoing_connections(self, pos):
        """The postsynaptic (row, col) positions of ``pos``."""
        flat = self.graph.get_outgoing_connections(self._flat(pos))
        return {(i // self.cols, i % self.cols) for i in flat}

    # -- per-neuron mutation ----------------------------------------------------
    def apply(self, fn):
        """fn(state dict) -> state dict, on whole (N,) tensors."""
        self.state = dict(fn(dict(self.state)))

    def apply_given_position(self, fn):
        """fn(rr, cc, state) -> state; rr/cc are (N,) position index tensors."""
        rr, cc = torch.meshgrid(torch.arange(self.rows, device=self.device),
                                torch.arange(self.cols, device=self.device),
                                indexing="ij")
        self.state = dict(fn(rr.reshape(-1), cc.reshape(-1), dict(self.state)))

    def set_dt(self, dt):
        self.state["dt"] = torch.full_like(self.state["dt"], dt)
        self.plasticity.set_dt(dt)

    def reset_timing(self):
        self.internal_clock = 0
        self.state["last_firing_time"] = torch.full_like(
            self.state["last_firing_time"], NEVER)

    def reset_history(self):
        self.grid_history.reset()
        self.graph_history.clear()

    # -- simulation -------------------------------------------------------------
    def _history_items(self):
        if not self.update_grid_history:
            return ()
        return (("grid", self.grid_history),)

    def update(self):
        """One lattice step."""
        self.run_lattice(1)

    def run_lattice(self, iterations):
        """Advance ``iterations`` steps, in chunks that bound the history
        readouts kept on the device."""
        if iterations == 0 or (not self.electrical_synapse
                               and not self.chemical_synapse):
            return
        with profiling.span("lattice.run"):
            bps = 0
            if self.update_grid_history:
                bps += history_step_bytes(self.grid_history.kind, self.n)
            if self.update_graph_history:
                bps += 4 * self.graph.weights.numel()
            hchunk = resolve_history_chunk(self.history_chunk, bps)
            remaining = iterations
            while remaining > 0:
                chunk = min(remaining, hchunk) \
                    if (self.update_grid_history
                        or self.update_graph_history) else remaining
                self._run_chunk(chunk)
                remaining -= chunk

    def _kernel_route(self, skip_nt, on_card=None):
        """The kernel route of this chunk: "hh" (the HH chemical kernel),
        "kernel" (the stencil kernel), "model" (the model kernel), an STDP
        `reward_kernels.LatSpec`, or None for the plain route.
        ``on_card`` (by default, whether the state is on a CUDA device)
        decides ``use_kernel=None``; `diagnostics.why_not_fused` asks
        with True."""
        if self.use_kernel is False:
            return None
        if hh_kernels.supports(self.model, self.graph, self.chemical_synapse,
                               self.do_plasticity, self.plasticity):
            # the HH gate reads no neurotransmitter mask; the kernel keeps
            # no history
            route = None if self._history_items() \
                or self.update_graph_history else "hh"
        elif not skip_nt:
            return None
        elif self.do_plasticity:
            route = None if self.update_graph_history \
                else reward_kernels.plain_stdp_lattice_spec(self)
        elif stencil_kernels.supports(
                self.model, self.graph, self.electrical_synapse,
                self.chemical_synapse, self.do_plasticity):
            route = "kernel"
        elif not self._history_items() and not self.update_graph_history \
                and model_kernels.supports_model(
                    self.model, self.graph, self.electrical_synapse,
                    self.chemical_synapse, self.do_plasticity):
            route = "model"
        else:
            route = None
        if on_card is None:
            on_card = self.state["v"].is_cuda
        if self.use_kernel is None and not on_card:
            return None
        return route

    def _run_chunk(self, length):
        readouts = self._history_items()
        if shard_of(self) is not None:
            ys = self._shard.run_lattice_chunk(self, length)
        else:
            ys = self._run_route(length, readouts)
        self.internal_clock += length
        for name, hist in readouts:
            hist.extend(ys[name].cpu())
        if self.update_graph_history:
            if "__weights__" in ys:
                self.graph_history.extend(ys["__weights__"].cpu().numpy())
            else:
                # no plasticity: every step's weights are the current ones
                w = self.graph.weights.cpu().numpy()
                self.graph_history.extend(np.repeat(w[None], length, axis=0))

    def _run_route(self, length, readouts):
        """One chunk of an unsharded lattice over its route; returns the
        history readouts by name."""
        with profiling.span("lattice.route"):
            # no neurotransmitter inserted: the NT update is a masked no-op
            with profiling.span("wait.nt_mask"):
                skip_nt = not bool(self.state["nt$mask"].any())
            route = self._kernel_route(skip_nt)
        if route == "hh":
            self._run_hh(length)
            ys = {}
            self._last_run_fused = "hh"
        elif route == "kernel":
            ys = self._run_kernel(length, readouts)
            self._last_run_fused = ("kernel", bool(readouts))
        elif route == "model":
            self._run_model(length)
            ys = {}
            self._last_run_fused = "model"
        elif route is not None:
            ys = self._run_stdp(length, readouts, route)
            self._last_run_fused = ("stdp", bool(readouts))
        else:
            ys = self._run_plain(length, readouts, skip_nt)
            self._last_run_fused = False
        return ys

    def _run_hh(self, length):
        """K steps per call of the HH chemical kernel, from the flat
        state; STDP updates one copy of the weights per run, in place."""
        g = self.graph
        rule = self.plasticity.params if self.do_plasticity else None
        weights = g.weights.clone() if self.do_plasticity else g.weights
        st, done = self.state, 0
        while done < length:
            n = min(hh_kernels.STEPS_PER_LAUNCH, length - done)
            st, weights = hh_kernels.hh_steps(
                st, weights, g.mask, g.in_deg, g.offsets,
                self.internal_clock + done, n, self.electrical_synapse,
                self.model.nt_kinetics, self.model.rec_kinetics, rule,
                _own=True)
            done += n
        self.state = st
        if self.do_plasticity:
            self.graph = g.replace_weights(weights)

    def _run_stdp(self, length, readouts, spec):
        """K steps per call of the plasticity kernel of kind ``plastic``;
        a grid history is rebuilt from the emitted pre-reset v."""
        shape = (self.rows, self.cols)
        st, weights, _, _, v_pre = reward_kernels.advance(
            spec, self.state, self.graph, None, None,
            self.plasticity.params, None, self.internal_clock, length, shape)
        if readouts:
            ys = rebuilt_readouts(v_pre, self.state["v_th"].reshape(shape),
                                  self.state["c"].reshape(shape), readouts,
                                  shape)
        else:
            ys = {}
        self.state = st
        self.graph = self.graph.replace_weights(weights)
        return ys

    def _run_kernel(self, length, readouts):
        """K steps per kernel call; with histories on, each call emits its
        steps' pre-reset v, from which post-reset v and spikes are rebuilt
        with the kernel's own ops (spike = v_pre >= v_th, v = c on spike).
        One `stencil_kernels.StencilRun` makes the checks, the uniform
        check, the route and the buffers once for the chunk's calls."""
        shape = (self.rows, self.cols)
        st = self.state
        params = {k: st[k].reshape(shape)
                  for k in stencil_kernels.PARAM_ORDER}
        g = self.graph
        run = stencil_kernels.StencilRun(
            st["v"].reshape(shape), st["w"].reshape(shape),
            st["last_firing_time"].reshape(shape), g.weights, g.in_deg,
            params, g.offsets)
        parts = {name: [] for name, _ in readouts}
        clock, done = self.internal_clock, 0
        while done < length:
            n = min(stencil_kernels.STEPS_PER_LAUNCH, length - done)
            v, w, lft, spikes, v_pre = run.steps(clock, n,
                                                 emit=bool(readouts))
            if readouts:
                for name, y in rebuilt_readouts(
                        v_pre, params["v_th"], params["c"], readouts,
                        shape).items():
                    parts[name].append(y)
            clock += n
            done += n
        st = dict(st)
        st["v"] = v.reshape(-1)
        st["w"] = w.reshape(-1)
        st["last_firing_time"] = lft.reshape(-1)
        st["is_spiking"] = spikes.reshape(-1)
        self.state = st
        return {name: torch.cat(p) for name, p in parts.items()}

    def _run_model(self, length):
        """K steps per call of the model kernel, from the flat state: its
        fields as (rows, cols) planes, the carried ones written back.  One
        `model_kernels.ModelRun` makes the checks, the plan and the
        buffers once for the run's calls."""
        shape = (self.rows, self.cols)
        fields, _ = model_kernels.model_kernel_fields(self.model)
        st = self.state
        g = self.graph
        run = model_kernels.ModelRun(
            self.model, {k: st[k].reshape(shape) for k, _ in fields},
            st["last_firing_time"].reshape(shape), g.weights, g.in_deg,
            g.offsets)
        clock, done = self.internal_clock, 0
        while done < length:
            n = min(model_kernels.STEPS_PER_LAUNCH, length - done)
            carried, lft, _ = run.steps(clock, n)
            clock += n
            done += n
        st = dict(st)
        st.update((k, x.reshape(-1)) for k, x in carried.items())
        st["last_firing_time"] = lft.reshape(-1)
        self.state = st

    def _run_plain(self, length, readouts, skip_nt):
        shape = (self.rows, self.cols)
        state, graph, clock = self.state, self.graph, self.internal_clock
        pparams = rule_tensors(self.plasticity.params, self.device)
        weights = self.do_plasticity and self.update_graph_history
        parts = {name: [] for name, _ in readouts}
        if weights:
            parts["__weights__"] = []
        for _ in range(length):
            state, graph, clock = lattice_step(
                self.model, self.electrical_synapse, self.chemical_synapse,
                self.do_plasticity, skip_nt, self.plasticity, pparams, state,
                graph, clock)
            for name, h in readouts:
                parts[name].append(h.readout(state, shape))
            if weights:
                parts["__weights__"].append(graph.weights)
        self.state, self.graph = state, graph
        return {name: torch.stack(p) for name, p in parts.items()}

    # -- views ---------------------------------------------------------------
    def voltages(self):
        return self.state["v"].reshape(self.rows, self.cols).cpu().numpy()

    def field(self, name):
        arr = self.state[name].cpu().numpy()
        if arr.ndim == 1 and arr.shape[0] == self.n:
            return arr.reshape(self.rows, self.cols)
        return arr


def lattice_step(model, electrical, chemical, do_plasticity, skip_nt,
                 plasticity, pparams, state, graph, clock):
    """One lattice step in plain PyTorch: the electrical and (with
    ``chemical``) the neurotransmitter gathers from the previous state, then
    the model step, then ``last_firing_time = clock`` where the neuron
    spiked, then the plasticity update from the post-step state.
    ``pparams`` are the rule's parameters as 0-dim f32 tensors.  Returns
    ``(state, graph, clock + 1)``."""
    if do_plasticity and not hasattr(plasticity, "apply"):
        raise NotImplementedError(
            f"a Lattice's plasticity is STDP or BCM, not "
            f"{type(plasticity).__name__} (R-STDP runs on a "
            f"RewardModulatedLattice)")
    if electrical:
        sub_v = torch.ones_like(state["v"])
        elec = graph.gather_electrical(
            state["v"], sub_v, state["v"], state["gap_conductance"])
    else:
        elec = torch.zeros_like(state["v"])

    if chemical:
        t, mask = get_neurotransmitter_concentrations(state)
        t_in, t_valid = graph.gather_chemical(t, mask.to(torch.float32))
        state, spikes = model.step(state, elec, t_in, t_valid,
                                   skip_nt=skip_nt)
    else:
        state, spikes = model.step(state, elec, skip_nt=skip_nt)
    state["last_firing_time"] = state["last_firing_time"].masked_fill(
        spikes, clock)
    if do_plasticity:
        graph = plasticity.apply(graph, state, pparams)
    return state, graph, clock + 1

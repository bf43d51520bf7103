"""Reward-modulated (R-STDP) lattice runtime.

PyTorch counterpart of ``spiking_neural_networks_tpu/core/reward.py``.  Edge
weights carry eligibility-trace state: per-edge arrays ``c`` (trace),
``dw`` (accumulator) and ``counter`` (visit parity), shaped like the
graph's weights.  Every neuron triggers an update of its incoming and
outgoing edges each step, so each intra-lattice edge is visited twice per
step, with `rstdp_visit`:

    dw += stdp_delta
    if counter == 0: counter = 1
    else:            c = c * exp(-dt/tau_c) + tau_c * dw ; counter = 0 ; dw = 0
    weight += c * dopamine

The dopamine scalar decays with the reward before the visits.  Deltas are
taken from the post-step firing times of both endpoints.

``run_lattice_with_reward`` / ``run_lattice`` run one of two routes: the
kernel route, calls of `ops.reward_kernels.lattice_plasticity_steps` of
kind ``mod`` (or ``plain`` without modulation) advancing 16 steps each,
or the plain route, `reward_lattice_step` once per step in plain PyTorch
in place of the JAX package's ``lax.scan``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.base import NEVER, get_neurotransmitter_concentrations
from ..ops import reward_kernels
from ..ops.graph import SparseGraph, StencilGraph, connect_auto, radius_offsets
from .history import (GridVoltageHistory, history_step_bytes,
                      resolve_history_chunk)
from .sharded import block_info, shard_of, sharded_field
from .plasticity import RewardModulatedSTDP, rstdp_visit, rule_tensors
from .plasticity import stdp_delta as stdp_delta_arrays
from ..utils import profiling


class RewardModulatedLattice:
    """Lattice whose weights are dopamine-modulated eligibility traces, on
    ``device``.

    ``use_kernel`` picks the route as for `Lattice`: None (auto) takes the
    kernel route when the state is on a CUDA device, no history is on and
    `reward_kernels.supports_lattice` holds; True takes it wherever no
    history is on and the gate holds (on the CPU the wrapper runs the
    kernel's plain twin); False always runs `reward_lattice_step`.
    ``_last_run_fused`` is True when the last run took the kernel route.
    A sharded lattice (`shard`) runs `reward_lattice_step` per block.
    """

    # whole tensors; while sharded, views assembled from the blocks
    state = sharded_field("state")
    graph = sharded_field("graph")
    trace = sharded_field("trace")
    blocks = property(block_info)

    def __init__(self, model, id=0, device="cuda"):
        self.model = model
        self.id = id
        self.device = torch.device(device)
        self.state = None
        self.graph = None
        self.trace = None  # dict(c, dw, counter) shaped like graph.weights
        self.rows = self.cols = 0
        self.electrical_synapse = True
        self.chemical_synapse = False
        self.do_modulation = True
        self.do_plasticity = False  # (STDP never applies; modulation does)
        self.reward_modulator = RewardModulatedSTDP()
        self.dopamine = 0.0
        self.update_grid_history = False
        self.grid_history = GridVoltageHistory()
        self.update_graph_history = False
        self.graph_history = []
        self.internal_clock = 0
        self.history_chunk = None  # None = auto (core/history)
        self.use_kernel = None
        self._last_run_fused = False
        self.mesh = None

    @property
    def n(self):
        return self.rows * self.cols

    def populate(self, rows, cols, **overrides):
        """(Re)build the cell grid on the lattice's device, with a zero-edge
        graph and empty traces."""
        self.rows, self.cols = rows, cols
        self.state = self.model.init_state(rows * cols, device=self.device,
                                           **overrides)
        self.graph = SparseGraph.empty(self.n, device=self.device)
        self._reset_trace()

    def _reset_trace(self):
        shape = self.graph.weights.shape
        zeros = dict(dtype=torch.float32, device=self.device)
        self.trace = dict(c=torch.zeros(shape, **zeros),
                          dw=torch.zeros(shape, **zeros),
                          counter=torch.zeros(shape, dtype=torch.int32,
                                              device=self.device))

    def connect(self, connecting_conditional, weight_logic=None):
        """`Lattice.connect`: a pairwise predicate, decomposed into a
        `StencilGraph` on the host where its offset support is narrow (a
        `DenseGraph` otherwise); resets the traces."""
        self.graph = connect_auto(self.rows, self.cols, connecting_conditional,
                                  weight_logic, device=self.device)
        self._reset_trace()

    def connect_stencil(self, radius=None, offsets=None, weight_fn=None,
                        keep_prob=1.0, seed=0):
        if offsets is None:
            offsets = radius_offsets(radius)
        self.graph = StencilGraph.build(self.rows, self.cols, offsets,
                                        weight_fn=weight_fn,
                                        keep_prob=keep_prob, seed=seed,
                                        device=self.device)
        self._reset_trace()

    def apply(self, fn):
        self.state = dict(fn(dict(self.state)))

    def shard(self, mesh, axis="tp"):
        """Split the state, graph and trace planes over ``mesh`` in row
        blocks (`parallel.lattice_sharding`); the dopamine stays one
        scalar that every block computes alike."""
        from ..parallel.lattice_sharding import shard_lattice
        return shard_lattice(self, mesh, axis)

    # -- per-edge graph access ---------------------------------------------------
    def _flat(self, pos):
        from ..errors import GraphError
        r, c = pos
        if not (0 <= r < self.rows and 0 <= c < self.cols):
            raise GraphError(f"position {pos} not in lattice")
        return r * self.cols + c

    def lookup_weight(self, presynaptic, postsynaptic):
        return self.graph.lookup_weight(self._flat(presynaptic),
                                        self._flat(postsynaptic))

    def edit_weight(self, presynaptic, postsynaptic, weight):
        """Set, or with None remove, one synapse, carrying the eligibility
        traces with it.  Stencil and dense layouts are positional: a new
        stencil offset plane is zero-padded at the end.  A `SparseGraph`
        re-sorts its edge list on an edit, so its traces are remapped by
        (src, dst) pair: a removed edge drops its trace, an added edge
        starts at zero."""
        old_graph = self.graph
        self.graph = self.graph.edit_weight(self._flat(presynaptic),
                                            self._flat(postsynaptic), weight)
        if self.trace is None:
            return
        if isinstance(self.graph, SparseGraph):
            old_pos = {}
            if isinstance(old_graph, SparseGraph):
                old_pos = {(int(a), int(b)): k for k, (a, b) in enumerate(
                    zip(old_graph.src.tolist(), old_graph.dst.tolist()))}
            pairs = list(zip(self.graph.src.tolist(),
                             self.graph.dst.tolist()))
            for key, v in self.trace.items():
                host = v.cpu().numpy()
                out = np.zeros(len(pairs), host.dtype)
                for k, pair in enumerate(pairs):
                    idx = old_pos.get(pair)
                    if idx is not None and idx < len(host):
                        out[k] = host[idx]
                self.trace[key] = torch.from_numpy(out).to(self.device)
            return
        shape = self.graph.weights.shape
        if self.trace["c"].shape != shape:
            for k, v in self.trace.items():
                grown = torch.zeros(shape, dtype=v.dtype, device=v.device)
                grown[tuple(slice(0, n) for n in v.shape)] = v
                self.trace[k] = grown

    def get_incoming_connections(self, pos):
        flat = self.graph.get_incoming_connections(self._flat(pos))
        return {(i // self.cols, i % self.cols) for i in flat}

    def get_outgoing_connections(self, pos):
        flat = self.graph.get_outgoing_connections(self._flat(pos))
        return {(i // self.cols, i % self.cols) for i in flat}

    def set_dt(self, dt):
        self.state["dt"] = torch.full_like(self.state["dt"], dt)
        self.reward_modulator.set_dt(dt)

    def reset_timing(self):
        self.internal_clock = 0
        self.state["last_firing_time"] = torch.full_like(
            self.state["last_firing_time"], NEVER)

    # -- Agent interface --------------------------------------------------------
    def update_and_apply_reward(self, reward):
        self.run_lattice_with_reward(reward, 1)

    def update(self):
        self.run_lattice(1)

    # -- simulation -------------------------------------------------------------
    def run_lattice_with_reward(self, reward, iterations=1):
        """Iterate with a reward each step: ``reward`` is a scalar
        (constant) or a length-``iterations`` schedule."""
        rewards = np.broadcast_to(np.asarray(reward, np.float32),
                                  (iterations,))
        self._run(rewards, with_reward=True)

    def run_lattice(self, iterations):
        """Iterate without updating dopamine; modulation still applies with
        the stale dopamine value."""
        self._run(np.zeros((iterations,), np.float32), with_reward=False)

    def _run(self, rewards, with_reward):
        if not self.electrical_synapse and not self.chemical_synapse:
            return
        if int(rewards.shape[0]) == 0:
            return
        with profiling.span("reward.run"):
            self._run_steps(rewards, with_reward)

    def _run_steps(self, rewards, with_reward):
        iterations = int(rewards.shape[0])
        any_hist = self.update_grid_history or self.update_graph_history
        hchunk = resolve_history_chunk(
            self.history_chunk,
            (history_step_bytes(self.grid_history.kind, self.n)
             if self.update_grid_history else 0)
            + (4 * self.graph.weights.numel()
               if self.update_graph_history else 0))
        if any_hist and iterations > hchunk:
            for off in range(0, iterations, hchunk):
                self._run_steps(rewards[off:off + hchunk], with_reward)
            return
        self._last_run_fused = False
        if shard_of(self) is not None:
            self._shard.run_reward(self, rewards, with_reward)
        elif self._kernel_route(any_hist):
            self._run_kernel(rewards, with_reward)
            self._last_run_fused = True
        else:
            self._run_plain(rewards, with_reward)
        self.internal_clock += iterations

    def _kernel_route(self, any_hist, on_card=None):
        """Whether this run takes the kernel route (never while sharded:
        the blocks take `reward_lattice_step`); ``on_card`` (by default,
        whether the state is on a CUDA device) decides
        ``use_kernel=None``."""
        if any_hist or self.use_kernel is False \
                or shard_of(self) is not None \
                or not reward_kernels.supports_lattice(self):
            return False
        if on_card is None:
            on_card = self.state["v"].is_cuda
        return self.use_kernel is True or on_card

    def _dopamine_tensor(self):
        return torch.tensor(self.dopamine, dtype=torch.float32,
                            device=self.device)

    def _run_kernel(self, rewards, with_reward):
        with profiling.span("reward.setup"):
            spec = reward_kernels.LatSpec(
                "mod" if self.do_modulation else "plain",
                reward_kernels.model_kind(self.model), self.graph.offsets,
                with_reward=with_reward)
            dopamine = self._dopamine_tensor()
        st, weights, trace, dop, _ = reward_kernels.advance(
            spec, self.state, self.graph, self.trace, dopamine,
            self.reward_modulator.params, rewards, self.internal_clock,
            len(rewards), (self.rows, self.cols))
        self.state, self.trace = st, trace
        self.graph = self.graph.replace_weights(weights)
        with profiling.span("wait.dopamine"):
            self.dopamine = float(dop)

    def _run_plain(self, rewards, with_reward):
        with profiling.span("wait.nt_mask"):
            skip_nt = not bool(self.state["nt$mask"].any())
        shape = (self.rows, self.cols)
        pparams = rule_tensors(self.reward_modulator.params, self.device)
        state, graph, trace = self.state, self.graph, self.trace
        dopamine, clock = self._dopamine_tensor(), self.internal_clock
        grid, weights = [], []
        for reward in torch.from_numpy(np.array(rewards)).to(self.device):
            state, graph, trace, dopamine, clock = reward_lattice_step(
                self.model, self.electrical_synapse, self.chemical_synapse,
                self.do_modulation, with_reward, skip_nt, pparams, state,
                graph, trace, dopamine, clock, reward)
            if self.update_grid_history:
                grid.append(self.grid_history.readout(state, shape))
            if self.update_graph_history:
                weights.append(graph.weights)
        self.state, self.graph, self.trace = state, graph, trace
        self.dopamine = float(dopamine)
        if grid:
            self.grid_history.extend(torch.stack(grid).cpu())
        if weights:
            self.graph_history.extend(torch.stack(weights).cpu().numpy())

    def voltages(self):
        return self.state["v"].reshape(self.rows, self.cols).cpu().numpy()


def reward_lattice_step(model, electrical, chemical, do_modulation,
                        with_reward, skip_nt, pparams, state, graph, trace,
                        dopamine, clock, reward):
    """One reward-modulated lattice step in plain PyTorch: the electrical
    gather, the dopamine update (with a reward), the chemical gather and
    the model step, then the R-STDP double visit of every edge from the
    post-step firing times.
    ``pparams``, ``dopamine`` and ``reward`` are 0-dim f32 tensors.
    Returns ``(state, graph, trace, dopamine, clock + 1)``."""
    if electrical:
        sub_v = torch.ones_like(state["v"])
        elec = graph.gather_electrical(
            state["v"], sub_v, state["v"], state["gap_conductance"])
    else:
        elec = torch.zeros_like(state["v"])

    if with_reward:
        dopamine = RewardModulatedSTDP.update_dopamine(dopamine, reward,
                                                       pparams)

    if chemical:
        t, mask = get_neurotransmitter_concentrations(state)
        t_in, t_valid = graph.gather_chemical(t, mask.to(torch.float32))
        state, spikes = model.step(state, elec, t_in, t_valid,
                                   skip_nt=skip_nt)
    else:
        state, spikes = model.step(state, elec, skip_nt=skip_nt)
    state["last_firing_time"] = state["last_firing_time"].masked_fill(
        spikes, clock)

    if do_modulation:
        vals = {"last_firing_time": state["last_firing_time"]}
        graph, trace = modulate(graph, trace, vals, vals, dopamine, pparams)

    return state, graph, trace, dopamine, clock + 1


def modulate(graph, trace, pre_vals, post_vals, dopamine, pparams):
    """The R-STDP double visit of every edge of ``graph`` from the
    endpoints' post-step firing times (``pre_vals`` / ``post_vals``: the
    sources' and destinations' ``last_firing_time``, which differ for a
    sharded column block).  Returns ``(graph, trace)``."""
    pre, post = graph.edge_pre_post(pre_vals, post_vals)
    delta = stdp_delta_arrays(pre["last_firing_time"],
                              post["last_firing_time"], pparams)
    w0 = graph.weights
    w, c, dw, ct = rstdp_visit(
        w0, trace["c"], trace["dw"], trace["counter"], delta,
        dopamine, pparams)
    w, c, dw, ct = rstdp_visit(w, c, dw, ct, delta, dopamine, pparams)
    m = graph.edge_mask
    graph = graph.replace_weights(torch.where(m, w, w0))
    trace = dict(c=torch.where(m, c, trace["c"]),
                 dw=torch.where(m, dw, trace["dw"]),
                 counter=torch.where(m, ct, trace["counter"]))
    return graph, trace

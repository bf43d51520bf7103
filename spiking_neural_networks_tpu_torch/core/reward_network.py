"""Reward-modulated lattice network: plain and reward-modulated lattices.

PyTorch counterpart of ``spiking_neural_networks_tpu/core/reward_network.py``
(`RewardModulatedLatticeNetwork`): ordinary lattices (STDP), reward-
modulated lattices (R-STDP trace weights) and spike-train lattices, joined
by plain connections and by reward-modulated connections, whose edges
carry (w, c, dw, counter) as the reward lattices' intra edges do.  Per
step:

* modulated edges take 0-2 R-STDP visits: one per endpoint in a reward
  lattice with ``do_modulation`` (every step) plus one per spiking
  endpoint in a plain lattice with ``do_plasticity``; trains never
  trigger;
* plain edges take STDP visits: one per spiking plastic endpoint, plus a
  visit every step when one endpoint is a modulated lattice and the other
  a plain lattice.

The shared dopamine decays with the reward before the visits.  The
structure-preserving runner (`core/reward_structured.py`) is the default;
the flat COO path here (`LatticeNetwork._compile` plus per-edge traces,
stepped by `core.network.flat_steps`) is the fallback (a connecting-graph
history, a subclass, ``structured = False``; not for a sharded network,
which then raises) and the equivalence oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import LatticeNetworkError
from ..ops.graph import DenseGraph, SparseGraph, positions
from .network import LatticeNetwork, _device_tensor
from .plasticity import RewardModulatedSTDP
from .reward import RewardModulatedLattice


class RewardModulatedLatticeNetwork(LatticeNetwork):
    """`LatticeNetwork` with reward-modulated lattices and connections.

    Adds ``add_reward_modulated_lattice``,
    ``connect_with_reward_modulation`` and ``run_lattices_with_reward``,
    and the Agent trait (``update_and_apply_reward``, ``update``).
    ``reward_connections`` maps (pre, post) to host (src, dst, w, c, dw,
    counter) arrays.  ``use_kernel`` picks the route as for
    `LatticeNetwork`: the reward arm of the network kernels
    (`ops.network_kernels.reward_network_spec`) or the plain step loop;
    ``_last_run_fused`` is ``("reward", emit)`` after a kernel-route run,
    else False.
    """

    # the flat COO path carries trace state per edge: no dense products
    dense_gather = False

    def __init__(self, device=None):
        super().__init__(device)
        self.reward_modulated_lattices = {}
        self.reward_connections = {}
        self.reward_modulator = RewardModulatedSTDP()
        self.dopamine = 0.0
        self._structured_reward_plan = None

    def _check_id(self, id):
        if id in self.reward_modulated_lattices:
            raise LatticeNetworkError(f"id {id} already present in network")
        super()._check_id(id)

    def _check_model(self, lattice):
        lattices = self._neuron_lattices()
        if lattices and next(iter(lattices.values())).model != lattice.model:
            raise LatticeNetworkError(
                "all lattices must share one neuron model config")

    def add_lattice(self, lattice):
        if isinstance(lattice, RewardModulatedLattice):
            return self.add_reward_modulated_lattice(lattice)
        self._check_model(lattice)
        super().add_lattice(lattice)

    def add_reward_modulated_lattice(self, lattice):
        self._check_id(lattice.id)
        self._check_model(lattice)
        self._check_device(lattice)
        lattice.in_network = True
        self.reward_modulated_lattices[lattice.id] = lattice
        self._conn_version += 1

    def get_reward_modulated_lattice(self, id):
        return self.reward_modulated_lattices[id]

    def _neuron_lattices(self):
        out = dict(self.lattices)
        out.update(self.reward_modulated_lattices)
        return out

    def connect_with_reward_modulation(self, presynaptic_id, postsynaptic_id,
                                       connecting_conditional,
                                       weight_logic=None):
        """Connect by a predicate over (pre, post) positions with edges
        that carry fresh R-STDP traces.  O(N_pre * N_post) host calls."""
        lattices = self._neuron_lattices()
        if postsynaptic_id not in lattices:
            raise KeyError(f"unknown postsynaptic id {postsynaptic_id}")
        pre = lattices.get(presynaptic_id) \
            or self.spike_train_lattices.get(presynaptic_id)
        if pre is None:
            raise KeyError(f"unknown presynaptic id {presynaptic_id}")
        post = lattices[postsynaptic_id]
        src, dst, w = [], [], []
        for i, p1 in enumerate(positions(pre.rows, pre.cols)):
            t1 = (int(p1[0]), int(p1[1]))
            for j, p2 in enumerate(positions(post.rows, post.cols)):
                t2 = (int(p2[0]), int(p2[1]))
                if connecting_conditional(t1, t2):
                    src.append(i)
                    dst.append(j)
                    w.append(1.0 if weight_logic is None
                             else weight_logic(t1, t2))
        n = len(w)
        self.reward_connections[(presynaptic_id, postsynaptic_id)] = (
            np.asarray(src, np.int64), np.asarray(dst, np.int64),
            np.asarray(w, np.float32), np.zeros(n, np.float32),
            np.zeros(n, np.float32), np.zeros(n, np.int32))
        self._conn_version += 1

    # -- Agent trait ------------------------------------------------------------
    def update_and_apply_reward(self, reward):
        self.run_lattices_with_reward(reward, 1)

    def update(self):
        self.run_lattices(1)

    # -- simulation ---------------------------------------------------------------
    def _structured_supported(self):
        return (type(self) is RewardModulatedLatticeNetwork
                and not self.update_connecting_graph_history
                and self._neuron_lattices())

    def run_lattices(self, iterations):
        """Steps without a reward: the dopamine keeps its value and still
        modulates."""
        self.run_lattices_with_reward(np.zeros(iterations, np.float32),
                                      iterations, with_reward=False)

    def run_lattices_with_reward(self, reward, iterations=1,
                                 with_reward=True):
        """One dopamine update (with ``with_reward``) and one network step
        per iteration; ``reward`` is a scalar or an ``iterations`` long
        schedule."""
        if iterations == 0:
            return
        if not self.electrical_synapse and not self.chemical_synapse:
            return
        rewards = np.broadcast_to(np.asarray(reward, np.float32),
                                  (iterations,))
        chunk = self._history_chunk() if self._any_history() \
            else iterations
        if self.structured and self._structured_supported():
            from .reward_structured import run_structured_reward
            for off in range(0, iterations, chunk):
                run_structured_reward(self, rewards[off:off + chunk],
                                      with_reward)
            return
        plan = self._compile()
        for off in range(0, iterations, chunk):
            self._run_chunk(plan, len(rewards[off:off + chunk]),
                            rewards[off:off + chunk], with_reward)
        self._write_back_reward(plan)

    def run_lattices_with_reward_pipelined(self, reward, iterations=1,
                                           mesh=None, order=None,
                                           with_reward=True):
        """`run_lattices_with_reward` for a chain of lattices, one stage
        per mesh position (`parallel.pipeline.run_pipelined_with_reward`)."""
        if iterations == 0:
            return
        from ..parallel.pipeline import run_pipelined_with_reward
        run_pipelined_with_reward(self, reward, iterations, mesh=mesh,
                                  order=order, with_reward=with_reward)

    # -- the flat COO path --------------------------------------------------------
    def _compile(self):
        """`LatticeNetwork._compile` over every neuron lattice, with
        per-edge traces (the reward lattices' intra edges and the reward
        connections, appended after the plain edges), the ``modulated``
        edge flags, and the per-node ``node_mod`` (a reward lattice with
        ``do_modulation``) and ``node_plain`` (a plain lattice) flags."""
        plan = super()._compile()
        dev = plan["w"].device
        n_plain = plan["w"].shape[0]
        n_offset = plan["n_offset"]
        node_mod = np.zeros(plan["n_total"], np.float32)
        for i, lat in self.reward_modulated_lattices.items():
            if lat.do_modulation:
                node_mod[n_offset[i]:n_offset[i] + lat.n] = 1.0
        node_plain = np.zeros(plan["n_total"], np.float32)
        for i, lat in self.lattices.items():
            node_plain[n_offset[i]:n_offset[i] + lat.n] = 1.0
        c = np.zeros(n_plain, np.float32)
        dw = np.zeros(n_plain, np.float32)
        counter = np.zeros(n_plain, np.int32)
        modulated = np.zeros(n_plain, bool)
        offset = 0
        for kind, owner, count, prov, src, dst in plan["provenance"]:
            if kind == "intra" and owner in self.reward_modulated_lattices:
                modulated[offset:offset + count] = True
                tw = _trace_to_edges(self.reward_modulated_lattices[owner],
                                     src, dst)
                c[offset:offset + count] = tw[0]
                dw[offset:offset + count] = tw[1]
                counter[offset:offset + count] = tw[2]
            offset += count
        src_all = plan["src"].cpu().numpy()
        dst_all = plan["dst"].cpu().numpy()
        w_all = plan["w"].cpu().numpy()
        r_prov = []
        for key, (rs, rd, rw, rc, rdw, rct) in sorted(
                self.reward_connections.items()):
            pre_id, post_id = key
            base = n_offset.get(pre_id, plan["st_offset"].get(pre_id))
            src_all = np.concatenate([src_all, rs + base])
            dst_all = np.concatenate([dst_all, rd + n_offset[post_id]])
            w_all = np.concatenate([w_all, rw])
            c = np.concatenate([c, rc])
            dw = np.concatenate([dw, rdw])
            counter = np.concatenate([counter, rct])
            modulated = np.concatenate([modulated, np.ones(len(rw), bool)])
            r_prov.append((key, len(rw), rs, rd))
        in_deg = np.zeros(plan["n_neurons"], np.float32)
        np.add.at(in_deg, dst_all, 1.0)
        plastic = np.zeros(len(w_all), bool)
        plastic[:n_plain] = plan["plastic"].cpu().numpy()
        # does the reward sweep ever visit a plain edge (a modulated
        # endpoint on one side, a plain lattice on the other)?
        cross = (node_mod[src_all] * node_plain[dst_all]
                 + node_mod[dst_all] * node_plain[src_all])
        plan.update(
            src=_device_tensor(src_all.astype(np.int64), dev),
            dst=_device_tensor(dst_all.astype(np.int64), dev),
            w=_device_tensor(w_all.astype(np.float32), dev),
            plastic=_device_tensor(plastic, dev),
            in_deg=_device_tensor(in_deg, dev),
            trace=dict(c=_device_tensor(c, dev), dw=_device_tensor(dw, dev),
                       counter=_device_tensor(counter.astype(np.int32),
                                              dev)),
            node_mod=_device_tensor(node_mod, dev),
            node_plain=_device_tensor(node_plain, dev),
            modulated=_device_tensor(modulated, dev),
            stdp_cross_any=bool(cross[~modulated].max(initial=0.0) > 0),
            r_provenance=r_prov, n_edges_plain=n_plain)
        return plan

    def _write_back_reward(self, plan):
        """States, graphs and plain weights (`_write_back`), then the
        traces of the reward lattices, their dopamine, and the reward
        connections' host arrays; the structured plan's device copies are
        stale after that, so the connection version moves."""
        self._write_back(plan, plan["n_edges_plain"])
        w = plan["w"].cpu().numpy()
        c, dw, ct = (plan["trace"][k].cpu().numpy()
                     for k in ("c", "dw", "counter"))
        offset = 0
        for kind, owner, count, prov, src, dst in plan["provenance"]:
            if kind == "intra" and owner in self.reward_modulated_lattices:
                lat = self.reward_modulated_lattices[owner]
                _edges_to_trace(lat, src, dst, c[offset:offset + count],
                                dw[offset:offset + count],
                                ct[offset:offset + count])
                lat.dopamine = self.dopamine
            offset += count
        pos = plan["n_edges_plain"]
        for key, count, src, dst in plan["r_provenance"]:
            sl = slice(pos, pos + count)
            self.reward_connections[key] = (src, dst, w[sl].copy(),
                                            c[sl].copy(), dw[sl].copy(),
                                            ct[sl].copy())
            pos += count
        self._conn_version += 1


def _trace_to_edges(lattice, src, dst):
    """A reward lattice's (c, dw, counter) per edge, in `_graph_to_coo`'s
    edge order."""
    tr = {k: v.cpu().numpy() for k, v in lattice.trace.items()}
    g = lattice.graph
    if isinstance(g, DenseGraph):
        return tuple(tr[k][src, dst] for k in ("c", "dw", "counter"))
    if isinstance(g, SparseGraph):
        return tuple(tr[k] for k in ("c", "dw", "counter"))
    mask = g.mask.cpu().numpy()
    return tuple(tr[k][mask] for k in ("c", "dw", "counter"))


def _edges_to_trace(lattice, src, dst, c, dw, ct):
    """Per-edge traces back into the reward lattice's layout."""
    g = lattice.graph
    tr = {k: v.cpu().numpy().copy() for k, v in lattice.trace.items()}
    for k, vals in (("c", c), ("dw", dw), ("counter", ct)):
        if isinstance(g, DenseGraph):
            tr[k][src, dst] = vals
        elif isinstance(g, SparseGraph):
            tr[k] = np.asarray(vals, tr[k].dtype)
        else:
            tr[k][g.mask.cpu().numpy()] = vals
    lattice.trace = {k: torch.from_numpy(v).to(lattice.device)
                     for k, v in tr.items()}

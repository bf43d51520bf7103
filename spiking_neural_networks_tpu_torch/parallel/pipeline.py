"""Pipelines: a chain of lattices, one stage per mesh position.

PyTorch counterpart of ``spiking_neural_networks_tpu/parallel/
pipeline.py``.  A network whose lattices form a chain (stage 0 -> 1 ->
... -> S-1 by one-to-one connections) runs with stage ``s``'s state,
graph and incoming connection on mesh position ``s``'s device.  A step:

1. the previous stage's step-(t-1) fields hop one stage (a copy to the
   next stage's device): v (electrical) and the neurotransmitter
   concentrations and presence (chemical);
2. every stage steps in the structured runner's expression order
   (`core.structured._plain_steps` specialised to one lattice plus one
   incoming one-to-one connection);
3. the previous stage's post-step rule fields hop, and each stage's
   intra and incoming connection weights take the rule's visits.

An SNN chain is a systolic array in time (stage k + 1's step t reads
stage k's step t - 1), so every stage computes every step: no bubbles.
The JAX package runs this path in XLA, not Pallas: here it is plain
PyTorch on each stage's device.  Spike-train lattices are not part of a
chain.  Reward-modulated chains run through `run_pipelined_with_reward`
(reward or plain stages, reward or plain links, R-STDP traces per stage,
one dopamine scalar that every stage computes alike).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.plasticity import (RewardModulatedSTDP, rstdp_visit,
                               rule_tensors, stdp_delta)
from ..core.structured import (_chem_counts, _conn_edge_update, _conn_gather,
                               _conn_gather_chemical)
from ..errors import LatticeNetworkError
from ..models.base import get_neurotransmitter_concentrations
from ..ops.graph import DenseGraph, StencilGraph
from .mesh import Mesh, device_array


def make_pipeline_mesh(n_stages, devices=None, axis="pp"):
    """A 1-D mesh with one position per stage, by default over the
    visible CUDA devices (raises where fewer exist; name repeated devices
    for virtual stages)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < n_stages:
        raise ValueError(
            f"pipeline of {n_stages} stages needs {n_stages} devices, "
            f"have {len(devices)}")
    return Mesh(device_array(devices[:n_stages]), (axis,))


def _chain_order(net, order):
    """Validate the chain topology and return the stage order."""
    if net.spike_train_lattices:
        raise LatticeNetworkError(
            "pipelined networks cannot contain spike-train lattices; "
            "drive stage 0 via state overrides")
    if getattr(net, "reward_modulated_lattices", None) \
            or getattr(net, "reward_connections", None):
        raise LatticeNetworkError(
            "pipelined execution does not support reward-modulated "
            "lattices or reward connections; use run_pipelined_with_reward")
    if order is None:
        order = sorted(net.lattices)
    if sorted(order) != sorted(net.lattices):
        raise LatticeNetworkError("order must list every lattice id once")
    links = {(order[k], order[k + 1]) for k in range(len(order) - 1)}
    extra = set(net.connections) - links
    if extra:
        raise LatticeNetworkError(
            f"not a chain: connections {sorted(extra)} are not stage->next")
    return list(order)


def _reward_chain_order(net, order):
    if net.spike_train_lattices:
        raise LatticeNetworkError(
            "pipelined networks cannot contain spike-train lattices")
    all_ids = dict(net.lattices)
    all_ids.update(net.reward_modulated_lattices)
    if order is None:
        order = sorted(all_ids)
    if sorted(order) != sorted(all_ids):
        raise LatticeNetworkError("order must list every lattice id once")
    links = {(order[k], order[k + 1]) for k in range(len(order) - 1)}
    extra = (set(net.connections) | set(net.reward_connections)) - links
    if extra:
        raise LatticeNetworkError(
            f"not a chain: connections {sorted(extra)} are not stage->next")
    both = set(net.connections) & set(net.reward_connections)
    if both:
        raise LatticeNetworkError(
            f"links {sorted(both)} are both plain and reward-modulated")
    return list(order), all_ids


def _stack_graphs(lattices):
    """Check that the stages' intra graphs share one backend and (for
    stencils) one offset set; returns the backend."""
    g0 = lattices[0].graph
    if isinstance(g0, StencilGraph):
        for lat in lattices:
            if not isinstance(lat.graph, StencilGraph) \
                    or lat.graph.offsets != g0.offsets:
                raise LatticeNetworkError(
                    "pipelined stages need identical stencil offset sets")
        return "stencil"
    if isinstance(g0, DenseGraph):
        for lat in lattices:
            if not isinstance(lat.graph, DenseGraph):
                raise LatticeNetworkError(
                    "pipelined stages need one intra-graph backend")
        return "dense"
    raise LatticeNetworkError(
        "pipelined intra graphs must be StencilGraph or DenseGraph "
        f"(got {type(g0).__name__}); COO edge lists have no stage-"
        "stackable layout")


def _one_to_one(src, dst):
    src, dst = np.asarray(src), np.asarray(dst)
    if len(src) and not (src == dst).all():
        raise LatticeNetworkError(
            "pipelined connecting edges must be one-to-one "
            "(src position == dst position)")
    return dst


def _stack_connections(net, order, n, reward=False):
    """Per stage, the one-to-one link into it as (n,) host arrays: w,
    mask, in_deg, and with ``reward`` the modulated flag and the traces c,
    dw, counter (stage 0's all zero)."""
    out = []
    for s in range(len(order)):
        link = (order[s - 1], order[s]) if s else None
        rows = dict(w=np.zeros(n, np.float32), mask=np.zeros(n, bool))
        if reward:
            rows.update(modulated=np.zeros(n, np.float32),
                        c=np.zeros(n, np.float32), dw=np.zeros(n, np.float32),
                        counter=np.zeros(n, np.int32))
        if link in net.connections:
            src, dst, w = net.connections[link]
            dst = _one_to_one(src, dst)
            rows["w"][dst], rows["mask"][dst] = w, True
        elif reward and link in net.reward_connections:
            src, dst, w, c, dw, ct = net.reward_connections[link]
            dst = _one_to_one(src, dst)
            rows["w"][dst], rows["mask"][dst] = w, True
            rows["modulated"][dst] = 1.0
            rows["c"][dst], rows["dw"][dst], rows["counter"][dst] = c, dw, ct
        rows["in_deg"] = rows["mask"].astype(np.float32)
        out.append(rows)
    return out


def _history_sig(lattices):
    """The stages' shared grid-history kind, or None."""
    flags = {bool(lat.update_grid_history) for lat in lattices}
    if flags == {False}:
        return None
    if flags != {True}:
        raise LatticeNetworkError(
            "grid history must be enabled on all stages or none")
    if len({lat.grid_history.kind for lat in lattices}) != 1:
        raise LatticeNetworkError(
            "pipelined stages must share one grid-history kind")
    return lattices[0].grid_history.kind


class _Stages:
    """The stages' data on their devices: state, graph, incoming link (w
    and aux planes, a reward link's traces), and the write-back."""

    def __init__(self, net, order, lattices, mesh, reward=False):
        if mesh.size != len(lattices):
            raise LatticeNetworkError(
                f"mesh has {mesh.size} devices for {len(lattices)} stages")
        shape0 = (lattices[0].rows, lattices[0].cols)
        for lat in lattices:
            if (lat.rows, lat.cols) != shape0:
                raise LatticeNetworkError(
                    "pipelined stages must share (rows, cols)")
        self.kind = _stack_graphs(lattices)
        self.hist = _history_sig(lattices)
        self.devices = list(mesh.devices.reshape(-1))
        self.shape = shape0
        rows = _stack_connections(net, order, lattices[0].n, reward)
        self.states, self.graphs, self.conn_w, self.aux = [], [], [], []
        self.ctrace, self.itrace = [], []
        for lat, dev, r in zip(lattices, self.devices, rows):
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            self.states.append({k: v.to(dev) for k, v in lat.state.items()})
            g = lat.graph
            self.graphs.append(
                StencilGraph(g.offsets, g.weights.to(dev), g.mask.to(dev),
                             g.in_deg.to(dev)) if self.kind == "stencil"
                else DenseGraph(g.weights.to(dev), g.mask.to(dev)))
            self.conn_w.append(t(r["w"]))
            self.aux.append({k: t(r[k]) for k in ("mask", "in_deg")
                             + (("modulated",) if reward else ())})
            if reward:
                self.ctrace.append({k: t(r[k])
                                    for k in ("c", "dw", "counter")})
                tr = getattr(lat, "trace", None)
                w = g.weights
                self.itrace.append(
                    {k: (tr[k].to(dev) if tr is not None
                         else torch.zeros(w.shape, dtype=dt, device=dev))
                     for k, dt in (("c", torch.float32),
                                   ("dw", torch.float32),
                                   ("counter", torch.int32))})
        self.parts = [[] for _ in lattices]

    def hop(self, xs):
        """The previous stage's values on each stage's device (stage 0:
        zeros)."""
        return [torch.zeros_like(xs[0]).to(self.devices[0])] + [
            xs[s - 1].to(self.devices[s]) for s in range(1, len(xs))]

    def phase_a(self, net):
        """Every stage's electrical input and chemical sums and counts
        from the previous step's fields (the previous stage's hopped)."""
        ones = [torch.ones_like(s["v"]) for s in self.states]
        v_prev = self.hop([s["v"] for s in self.states])
        inputs, chem = [], []
        if net.chemical_synapse:
            tms = [get_neurotransmitter_concentrations(s) for s in self.states]
            t_prev = self.hop([t for t, _ in tms])
            m_prev = self.hop([m.to(torch.float32) for _, m in tms])
        for k, s in enumerate(self.states):
            g, v = self.graphs[k], s["v"]
            if net.electrical_synapse:
                total = g.gather_electrical(v, ones[k], v, ones[k]) \
                    * torch.clamp(g.in_degree(), min=1.0)
                cnt = g.in_degree()
                total = total + _conn_gather("one2one", self.aux[k],
                                             self.conn_w[k], v_prev[k],
                                             ones[k], v)
                cnt = cnt + self.aux[k]["in_deg"]
                inputs.append(s["gap_conductance"] * total
                              / torch.clamp(cnt, min=1.0))
            else:
                inputs.append(torch.zeros_like(v))
            if net.chemical_synapse:
                t, m = tms[k]
                m = m.to(torch.float32)
                t_in, _ = g.gather_chemical(t, m)
                gc = _chem_counts(g, m)
                csum = t_in * torch.clamp(gc, min=1.0) * (gc > 0.0)
                sums, cnts = _conn_gather_chemical(
                    "one2one", self.aux[k], self.conn_w[k], t_prev[k],
                    m_prev[k])
                chem.append((csum + sums, gc + cnts))
        return inputs, chem

    def phase_b(self, model, inputs, chem, skip_nt, clock):
        """Step every stage and stamp the firing times."""
        spikes = []
        for k, s in enumerate(self.states):
            if chem:
                csum, ccnt = chem[k]
                s, spk = model.step(s, inputs[k],
                                    csum / torch.clamp(ccnt, min=1.0),
                                    ccnt > 0.0, skip_nt=skip_nt)
            else:
                s, spk = model.step(s, inputs[k], skip_nt=skip_nt)
            s["last_firing_time"] = s["last_firing_time"].masked_fill(spk,
                                                                      clock)
            self.states[k] = s
            spikes.append(spk)
        return spikes

    def readout(self, lattices):
        if self.hist is None:
            return
        for k, lat in enumerate(lattices):
            self.parts[k].append(lat.grid_history.readout(self.states[k],
                                                          self.shape))

    def flush(self, lattices):
        """A chunk's history readouts into the lattices' histories."""
        for k, lat in enumerate(lattices):
            if self.parts[k]:
                lat.grid_history.extend(torch.stack(self.parts[k]).cpu())
            self.parts[k] = []

    def write_back(self, net, order, lattices):
        for k, lat in enumerate(lattices):
            dev = lat.device
            lat.state = {key: v.to(dev) for key, v in self.states[k].items()}
            lat.graph = self.graphs[k].replace_weights(
                self.graphs[k].weights.to(dev)) if self.kind == "dense" \
                else StencilGraph(lat.graph.offsets,
                                  self.graphs[k].weights.to(dev),
                                  lat.graph.mask, lat.graph.in_deg)
            lat.internal_clock = net.internal_clock
        for k in range(1, len(order)):
            link = (order[k - 1], order[k])
            w = self.conn_w[k].cpu().numpy()
            if link in net.connections:
                src, dst, _ = net.connections[link]
                net.connections[link] = (src, dst, w[np.asarray(dst)])
            elif link in getattr(net, "reward_connections", {}):
                src, dst = net.reward_connections[link][:2]
                d = np.asarray(dst)
                tr = {key: x.cpu().numpy()[d]
                      for key, x in self.ctrace[k].items()}
                net.reward_connections[link] = (src, dst, w[d], tr["c"],
                                                tr["dw"], tr["counter"])
        net._conn_version += 1


def _chunks(net, iterations, hist):
    """Steps per chunk: history runs are chunked as `run_lattices`
    chunks them."""
    size = net._history_chunk() if hist is not None else int(iterations)
    off = 0
    while off < int(iterations):
        n = min(int(iterations) - off, size)
        yield off, n
        off += n


def run_pipelined(net, iterations, mesh=None, order=None, axis="pp"):
    """Run a chain-topology `LatticeNetwork` with one stage per position
    of a 1-D mesh (by default one per visible CUDA device), and write the
    states, weights, connection weights, clocks and grid histories back
    as `run_lattices` would."""
    order = _chain_order(net, order)
    lattices = [net.lattices[i] for i in order]
    if mesh is None:
        mesh = make_pipeline_mesh(len(lattices), axis=axis)
    st = _Stages(net, order, lattices, mesh)
    model = lattices[0].model
    plasticity = net._plasticity()
    rule = type(plasticity)
    keys = rule.NODE_KEYS
    plastic = [bool(lat.do_plasticity) for lat in lattices]
    skip_nt = not any(bool(s["nt$mask"].any()) for s in st.states)
    pp = [rule_tensors(plasticity.params, d) for d in st.devices]
    for _, length in _chunks(net, iterations, st.hist):
        clock = net.internal_clock
        for _ in range(length):
            inputs, chem = st.phase_a(net)
            st.phase_b(model, inputs, chem, skip_nt, clock)
            if any(plastic):
                vals = [{key: s[key] for key in keys} for s in st.states]
                prev = [dict(zip(keys, x)) for x in zip(*[
                    st.hop([v[key] for v in vals]) for key in keys])]
                for k in range(len(lattices)):
                    if plastic[k]:
                        st.graphs[k] = st.graphs[k].apply_edge_update(
                            lambda w, pre, post, p=pp[k]: rule.apply_visits(
                                w, pre, post, p,
                                pre["is_spiking"].to(torch.float32)
                                + post["is_spiking"].to(torch.float32)) - w,
                            vals[k], vals[k])
                    pre_plastic = k > 0 and plastic[k - 1]
                    if not (pre_plastic or plastic[k]):
                        continue

                    def gated_delta(w, pre, post, p=pp[k],
                                    a=1.0 if pre_plastic else 0.0,
                                    b=1.0 if plastic[k] else 0.0):
                        count = (pre["is_spiking"].to(torch.float32) * a
                                 + post["is_spiking"].to(torch.float32) * b)
                        return rule.apply_visits(w, pre, post, p, count) - w

                    st.conn_w[k] = _conn_edge_update(
                        "one2one", st.aux[k], st.conn_w[k], gated_delta,
                        prev[k], vals[k])
            clock += 1
            st.readout(lattices)
        net.internal_clock += length
        st.flush(lattices)
    st.write_back(net, order, lattices)
    return net


def run_pipelined_with_reward(net, reward, iterations, mesh=None,
                              order=None, axis="pp", with_reward=True):
    """Run a chain-topology `RewardModulatedLatticeNetwork` with one stage
    per mesh position and write the states, weights, traces, connection
    weights and traces and the dopamine back as
    `run_lattices_with_reward` would.  A step, after the electrical and
    chemical phases: the dopamine update (every stage computes the same
    scalar), the model steps, then per stage the R-STDP double visit of a
    modulated stage's intra edges or the STDP visits of a plastic plain
    stage's, and on the incoming link per modulated edge one R-STDP visit
    per modulated endpoint and per spiking plastic endpoint (at most
    two), per plain edge one STDP visit per spiking plastic endpoint and
    per modulated endpoint facing a plain one."""
    order, all_lat = _reward_chain_order(net, order)
    lattices = [all_lat[i] for i in order]
    if mesh is None:
        mesh = make_pipeline_mesh(len(lattices), axis=axis)
    st = _Stages(net, order, lattices, mesh, reward=True)
    model = lattices[0].model
    plasticity = net._plasticity()
    rule = type(plasticity)
    skip_nt = not any(bool(s["nt$mask"].any()) for s in st.states)
    pp = [rule_tensors(plasticity.params, d) for d in st.devices]
    rp = [rule_tensors(net.reward_modulator.params, d) for d in st.devices]

    def flag_row(k):
        is_reward = order[k] in net.reward_modulated_lattices
        lat = lattices[k]
        return (float(is_reward and bool(lat.do_modulation)),
                float(not is_reward),
                float((not is_reward) and bool(lat.do_plasticity)))

    flags = [flag_row(k) + (flag_row(k - 1) if k else (0.0, 0.0, 0.0))
             for k in range(len(lattices))]
    rewards = torch.from_numpy(np.broadcast_to(
        np.asarray(reward, np.float32), (int(iterations),)).copy())
    dopamine = [torch.tensor(float(net.dopamine), dtype=torch.float32,
                             device=d) for d in st.devices]
    for off, length in _chunks(net, iterations, st.hist):
        clock = net.internal_clock
        for step in range(length):
            inputs, chem = st.phase_a(net)
            if with_reward:
                r = rewards[off + step]
                dopamine = [RewardModulatedSTDP.update_dopamine(
                    dopamine[k], r.to(d), rp[k])
                    for k, d in enumerate(st.devices)]
            spikes = st.phase_b(model, inputs, chem, skip_nt, clock)
            lft = [s["last_firing_time"] for s in st.states]
            lft_prev = st.hop(lft)
            spk_prev = st.hop([x.to(torch.float32) for x in spikes])
            for k in range(len(lattices)):
                _reward_stage(st, k, flags[k], lft[k], spikes[k],
                              lft_prev[k], spk_prev[k], dopamine[k], rp[k],
                              pp[k], rule)
            clock += 1
            st.readout(lattices)
        net.internal_clock += length
        st.flush(lattices)
    net.dopamine = float(dopamine[0])
    st.write_back(net, order, lattices)
    for k, lat in enumerate(lattices):
        if getattr(lat, "trace", None) is not None:
            lat.trace = {key: v.to(lat.device)
                         for key, v in st.itrace[k].items()}
            lat.dopamine = net.dopamine
    return net


def _reward_stage(st, k, flags, lft, spk, lft_pre, spk_pre, dopamine, rp,
                  pp, rule):
    """Stage ``k``'s intra and incoming-link weight and trace updates of
    one reward-pipeline step."""
    self_mod, self_plain, self_plast, pre_mod, pre_plain, pre_plast = flags
    g = st.graphs[k]
    vals = {"last_firing_time": lft, "is_spiking": spk}
    pre, post = g.edge_pre_post(vals, vals)
    emask, w0, it = g.edge_mask, g.weights, st.itrace[k]
    delta = stdp_delta(pre["last_firing_time"], post["last_firing_time"], rp)
    w1, c1, dw1, ct1 = rstdp_visit(w0, it["c"], it["dw"], it["counter"],
                                   delta, dopamine, rp)
    w1, c1, dw1, ct1 = rstdp_visit(w1, c1, dw1, ct1, delta, dopamine, rp)
    gate = emask & (self_mod > 0)
    new_w = torch.where(gate, w1, w0)
    st.itrace[k] = dict(c=torch.where(gate, c1, it["c"]),
                        dw=torch.where(gate, dw1, it["dw"]),
                        counter=torch.where(gate, ct1, it["counter"]))
    count = pre["is_spiking"].to(torch.float32) \
        + post["is_spiking"].to(torch.float32)
    w_stdp = rule.apply_visits(w0, pre, post, pp, count)
    new_w = torch.where(emask & (self_plast > 0), w_stdp, new_w)
    st.graphs[k] = g.replace_weights(new_w)

    cm, mod_edge = st.aux[k]["mask"], st.aux[k]["modulated"]
    conn_w, tr = st.conn_w[k], st.ctrace[k]
    delta_c = stdp_delta(lft_pre, lft, rp)
    spk_f = spk.to(torch.float32)
    trig_src, trig_dst = spk_pre * pre_plast, spk_f * self_plast
    visits = (pre_mod + self_mod + trig_src + trig_dst) * mod_edge
    w1, c1, dw1, ct1 = rstdp_visit(conn_w, tr["c"], tr["dw"], tr["counter"],
                                   delta_c, dopamine, rp)
    m1 = cm & (visits >= 1.0)
    cw = torch.where(m1, w1, conn_w)
    c_ = torch.where(m1, c1, tr["c"])
    dw_ = torch.where(m1, dw1, tr["dw"])
    ct_ = torch.where(m1, ct1, tr["counter"])
    w2, c2, dw2, ct2 = rstdp_visit(cw, c_, dw_, ct_, delta_c, dopamine, rp)
    m2 = cm & (visits >= 2.0)
    cw = torch.where(m2, w2, cw)
    st.ctrace[k] = dict(c=torch.where(m2, c2, c_),
                        dw=torch.where(m2, dw2, dw_),
                        counter=torch.where(m2, ct2, ct_))
    count_c = trig_src + trig_dst + pre_mod * self_plain \
        + self_mod * pre_plain
    pre_c = {"last_firing_time": lft_pre, "is_spiking": spk_pre > 0}
    post_c = {"last_firing_time": lft, "is_spiking": spk}
    w_plain = rule.apply_visits(cw, pre_c, post_c, pp, count_c)
    st.conn_w[k] = torch.where(cm & (mod_edge == 0.0), w_plain, cw)

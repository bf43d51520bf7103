"""Structure-preserving runner for `RewardModulatedLatticeNetwork`.

PyTorch counterpart of
``spiking_neural_networks_tpu/core/reward_structured.py``.  Each component
keeps its own layout, as in `core/structured.py`: intra synapses keep
their graph, and a reward lattice's (c, dw, counter) traces are shaped
like its weights; plain and reward connections are classified into the
structured operators, and a reward connection carries its traces in its
operator's layout.  Visits as in the flat COO path
(`core/reward_network.py`):

* modulated edges: one R-STDP visit per endpoint in a reward lattice with
  ``do_modulation`` (every step), plus one per spiking endpoint in a plain
  lattice with ``do_plasticity``;
* plain edges: STDP visits from spiking plastic endpoints, plus a visit
  every step where one endpoint is modulated and the other a plain
  lattice.

Lattice membership is static, so the endpoint flags are per-connection
constants (``static``, ``pre_plastic``, ``post_plastic``); only the
spiking terms change from step to step.  A step, in order: phase A, the
dopamine, phase B, STDP (plastic lattices, plain connections), the R-STDP
double visit of the modulated lattices, the reward connections, the trains
last.  `run_structured_reward` runs the reward arm of the network kernels
(`ops.network_kernels.reward_network_spec`, K = 16 steps per call) or
`_plain_reward_steps`, the plain step loop.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.spike_train import refractoriness_effect
from .plasticity import (RewardModulatedSTDP, rstdp_visit, rule_tensors,
                         stdp_delta)
from .sharded import first_shard
from .structured import (_conn_edge_update, _edge_layout, _phase_a,
                         _phase_b, classify_connection)


def compile_structured_reward(net):
    """The plan: sorted lattice and train ids, and per plain and reward
    connection its operator, endpoint flags, static visit count and
    ``updates`` flag (a reward connection's traces placed in its
    operator's layout as ``trace0``)."""
    lattices = net._neuron_lattices()
    reward_ids = set(net.reward_modulated_lattices)

    def flags(node_id):
        """(is_mod, is_plastic, is_plain) of an endpoint."""
        if node_id in reward_ids:
            return bool(lattices[node_id].do_modulation), False, False
        if node_id in net.lattices:
            return False, bool(net.lattices[node_id].do_plasticity), True
        return False, False, False

    def build(entries, reward):
        out = []
        for (pre_id, post_id), data in sorted(entries.items()):
            src, dst, w = (np.asarray(x) for x in data[:3])
            pre = lattices.get(pre_id) or net.spike_train_lattices[pre_id]
            post = lattices[post_id]
            pre_mod, pre_plastic, pre_plain = flags(pre_id)
            post_mod, post_plastic, post_plain = flags(post_id)
            if reward:
                static = int(pre_mod) + int(post_mod)
            else:
                static = int(pre_mod and post_plain) \
                    + int(post_mod and pre_plain)
            updates = bool(static or pre_plastic or post_plastic or reward)
            op = classify_connection(src, dst, w, pre.n, post.n, updates,
                                     pre_shape=(pre.rows, pre.cols),
                                     post_shape=(post.rows, post.cols),
                                     device=post.device)
            entry = dict(pre=pre_id, post=post_id, op=op,
                         key=(pre_id, post_id),
                         pre_is_st=pre_id in net.spike_train_lattices,
                         static=static, pre_plastic=pre_plastic,
                         post_plastic=post_plastic, updates=updates,
                         reward=reward)
            if reward:
                entry["trace0"] = dict(c=op.place(data[3]),
                                       dw=op.place(data[4]),
                                       counter=op.place(data[5], np.int32))
            out.append(entry)
        return out

    return dict(lat_ids=sorted(lattices),
                st_ids=sorted(net.spike_train_lattices),
                conns=build(net.connections, False),
                rconns=build(net.reward_connections, True))


def resolve_reward_plan(net):
    """The cached plan, rebuilt when the connection version, the plastic
    lattices' flags or the reward lattices' modulation flags changed."""
    version = (net._conn_version,
               tuple(bool(net.lattices[i].do_plasticity)
                     for i in sorted(net.lattices)),
               tuple((i, bool(net.reward_modulated_lattices[i].do_modulation))
                     for i in sorted(net.reward_modulated_lattices)))
    cached = net._structured_reward_plan
    if cached is not None and cached[0] == version:
        return cached[1]
    plan = compile_structured_reward(net)
    net._structured_reward_plan = (version, plan)
    return plan


def run_structured_reward(net, rewards, with_reward):
    """Advance the network ``len(rewards)`` steps over the reward arm of
    the network kernels or the plain route, then write back the states,
    graphs, traces, connection weights (device copies in the plan, host
    mirrors in ``connections`` and the 6-tuples of
    ``reward_connections``), the dopamine (into every reward lattice too)
    and the histories."""
    from ..ops import network_kernels as nk
    lattices_by_id = net._neuron_lattices()
    plan = resolve_reward_plan(net)
    lat_ids, st_ids = plan["lat_ids"], plan["st_ids"]
    lattices = [lattices_by_id[i] for i in lat_ids]
    sts = [net.spike_train_lattices[i] for i in st_ids]
    reward_ids = set(net.reward_modulated_lattices)
    lat_kind = tuple(
        ("mod" if lattices_by_id[i].do_modulation else "reward")
        if i in reward_ids
        else "plastic" if lattices_by_id[i].do_plasticity else "plain"
        for i in lat_ids)
    nt = [bool(x.state["nt$mask"].any()) for x in lattices + sts]
    skip_nt = not any(nt[:len(lattices)])
    hist = [(i, l) for i, l in zip(lat_ids, lattices) if l.update_grid_history]
    st_hist = [(i, s) for i, s in zip(st_ids, sts) if s.update_grid_history]
    ghist = [i for i, l in zip(lat_ids, lattices) if l.update_graph_history]
    length = len(rewards)
    shards = first_shard(lattices + sts)
    sharded = shards is not None
    spec = None
    if net.use_kernel is not False and not (hist or st_hist or ghist) \
            and not sharded:
        spec = nk.reward_network_spec(net, plan, lat_kind,
                                      skip_nt and not any(nt), with_reward)
        if spec is not None and net.use_kernel is None \
                and not lattices[0].state["v"].is_cuda:
            spec = None
    if sharded:
        # the blocks keep the states, graphs and traces
        conn_ws, rconns, dopamine, ys = shards.reward_network_steps(
            net, plan, rewards, with_reward, lat_kind, skip_nt, hist,
            st_hist, ghist)
        states = st_states = graphs = traces = ()
        net._last_run_fused = False
    elif spec is not None:
        states, st_states, graphs, conn_ws, ys, out = nk.advance(
            spec, net, plan, length, rewards)
        traces, rconns, dopamine = (out["traces"], out["rconns"],
                                    out["dopamine"])
        traces = [tr if tr is not None else lat.trace if i in reward_ids
                  else None
                  for i, lat, tr in zip(lat_ids, lattices, traces)]
        net._last_run_fused = ("reward", False)
    else:
        (states, st_states, graphs, traces, conn_ws, rconns, dopamine,
         ys) = _plain_reward_steps(net, plan, rewards, with_reward, lat_kind,
                                   skip_nt, hist, st_hist, ghist)
        net._last_run_fused = False
    net.internal_clock += length
    net.dopamine = dopamine
    for i, lat, state, graph, trace in zip(lat_ids, lattices, states, graphs,
                                           traces):
        lat.state = dict(state)
        lat.graph = graph
        if i in reward_ids:
            lat.trace = dict(trace)
    for st, state in zip(sts, st_states):
        st.state = dict(state)
    for i, x in zip(lat_ids + st_ids, lattices + sts):
        x.internal_clock = net.internal_clock
        if i in reward_ids:
            x.dopamine = dopamine
    for c, w in zip(plan["conns"], conn_ws):
        c["op"].w0 = w
        if c["updates"]:
            src, dst, _ = net.connections[c["key"]]
            net.connections[c["key"]] = (src, dst, c["op"].extract(w))
    for c, (w, tr) in zip(plan["rconns"], rconns):
        c["op"].w0, c["trace0"] = w, dict(tr)
        src, dst = net.reward_connections[c["key"]][:2]
        net.reward_connections[c["key"]] = (src, dst) + tuple(
            c["op"].extract(x) for x in (w, tr["c"], tr["dw"], tr["counter"]))
    for i, lat in hist:
        lat.grid_history.extend(ys[("lat", i)].cpu())
    for i, st in st_hist:
        st.grid_history.extend(ys[("st", i)].cpu())
    for i in ghist:
        lattices_by_id[i].graph_history.extend(ys[("gw", i)].cpu().numpy())


def _conn_reward_update(kind, aux, w, tr, static, pre_plastic, post_plastic,
                        pre_vals, post_vals, dopamine, rp):
    """Up to two gated R-STDP visits of one reward connection, in its
    operator's layout: the first where the visit count is >= 1, the
    second where it is >= 2, on masked slots."""
    if kind == "empty":
        return w, tr
    pre, post = _edge_layout(kind, aux, pre_vals, post_vals)
    delta = stdp_delta(pre["last_firing_time"], post["last_firing_time"], rp)
    visits = torch.full_like(delta, float(static))
    if pre_plastic:
        visits = visits + pre["trig"]
    if post_plastic:
        visits = visits + post["trig"]
    c, dw, ct = tr["c"], tr["dw"], tr["counter"]
    for n_visit in (1.0, 2.0):
        w1, c1, d1, t1 = rstdp_visit(w, c, dw, ct, delta, dopamine, rp)
        m = torch.logical_and(aux["mask"], visits >= n_visit)
        w, c = torch.where(m, w1, w), torch.where(m, c1, c)
        dw, ct = torch.where(m, d1, dw), torch.where(m, t1, ct)
    return w, dict(c=c, dw=dw, counter=ct)


def _plain_reward_steps(net, plan, rewards, with_reward, lat_kind, skip_nt,
                        hist, st_hist, ghist):
    """The plain PyTorch step loop of a reward network, in the XLA path's
    association.  Returns (states, st_states, graphs, traces, conn_ws,
    rconns, dopamine, ys): per lattice its trace dict (None for a plain
    lattice), per reward connection its (w, traces), the dopamine as a
    float and the stacked history readouts keyed ("lat", id), ("st", id),
    ("gw", id)."""
    lattices_by_id = net._neuron_lattices()
    lat_ids, st_ids = plan["lat_ids"], plan["st_ids"]
    conns, rconns = plan["conns"], plan["rconns"]
    lat_index = {i: k for k, i in enumerate(lat_ids)}
    st_index = {i: k for k, i in enumerate(st_ids)}
    lattices = [lattices_by_id[i] for i in lat_ids]
    sts = [net.spike_train_lattices[i] for i in st_ids]
    model = lattices[0].model
    st_model = sts[0].model if sts else None
    plasticity = net._plasticity()
    rule = type(plasticity)
    dev = lattices[0].device
    p = rule_tensors(plasticity.params, dev)
    rp = rule_tensors(net.reward_modulator.params, dev)
    states = [l.state for l in lattices]
    st_states = [s.state for s in sts]
    graphs = [l.graph for l in lattices]
    traces = [dict(l.trace) if k in ("mod", "reward") else None
              for l, k in zip(lattices, lat_kind)]
    conn_ws = [c["op"].w0 for c in conns]
    rconn_ws = [c["op"].w0 for c in rconns]
    rconn_tr = [dict(c["trace0"]) for c in rconns]
    all_meta = [((c["pre"], c["post"], c["op"].kind, c["pre_is_st"]),
                 c["op"].aux) for c in conns + rconns]
    dopamine = torch.tensor(float(net.dopamine), dtype=torch.float32,
                            device=dev)
    rewards = torch.from_numpy(np.array(rewards, np.float32)).to(dev)
    generator = net.generator()
    parts = {("lat", i): [] for i, _ in hist}
    parts.update({("st", i): [] for i, _ in st_hist})
    parts.update({("gw", i): [] for i in ghist})
    # the rule's fields and those R-STDP reads, at both ends of an edge
    keys = tuple(dict.fromkeys(("last_firing_time", "is_spiking")
                               + rule.NODE_KEYS + ("trig",)))
    clock = net.internal_clock

    def vals_of(node_id, spikes):
        """An endpoint's per-node fields: a train's (previous) ones, with
        no trigger and zeros for a field it lacks (a Poisson train's BCM
        activities); a lattice's post-step ones."""
        if node_id in st_index:
            s = st_states[st_index[node_id]]
            return {k: s[k] if k in s and k != "trig"
                    else torch.zeros_like(s["v"]) for k in keys}
        k = lat_index[node_id]
        return {key: spikes[k] if key == "is_spiking"
                else spikes[k].to(torch.float32) if key == "trig"
                else states[k][key] for key in keys}

    for reward in rewards:
        effects = [refractoriness_effect(st_model.refractoriness, s, clock)
                   for s in st_states]
        inputs, chem_sums, chem_cnts = _phase_a(
            lat_ids, lat_index, st_index, states, st_states, graphs,
            [(meta, aux, w) for (meta, aux), w
             in zip(all_meta, conn_ws + rconn_ws)],
            effects, net.electrical_synapse, net.chemical_synapse)
        if with_reward:
            dopamine = RewardModulatedSTDP.update_dopamine(dopamine, reward,
                                                           rp)
        states, spikes = _phase_b(model, states, inputs, chem_sums,
                                  chem_cnts, skip_nt, clock)
        for k, kind in enumerate(lat_kind):
            if kind != "plastic":
                continue
            vals = {key: states[k][key] for key in rule.NODE_KEYS}
            graphs[k] = graphs[k].apply_edge_update(
                lambda w, pre, post: rule.apply_visits(
                    w, pre, post, p, pre["is_spiking"].to(torch.float32)
                    + post["is_spiking"].to(torch.float32)) - w,
                vals, vals)
        for ci, c in enumerate(conns):
            if not c["updates"]:
                continue

            def gated_delta(w, pre, post, c=c):
                count = torch.full_like(w, float(c["static"]))
                if c["pre_plastic"]:
                    count = count + pre["trig"]
                if c["post_plastic"]:
                    count = count + post["trig"]
                return rule.apply_visits(w, pre, post, p, count) - w

            conn_ws[ci] = _conn_edge_update(
                c["op"].kind, c["op"].aux, conn_ws[ci], gated_delta,
                vals_of(c["pre"], spikes), vals_of(c["post"], spikes))
        for k, kind in enumerate(lat_kind):
            if kind != "mod":
                continue
            g, tr = graphs[k], traces[k]
            vals = {"last_firing_time": states[k]["last_firing_time"]}
            pre, post = g.edge_pre_post(vals, vals)
            delta = stdp_delta(pre["last_firing_time"],
                               post["last_firing_time"], rp)
            w, c, dw, ct = rstdp_visit(g.weights, tr["c"], tr["dw"],
                                       tr["counter"], delta, dopamine, rp)
            w, c, dw, ct = rstdp_visit(w, c, dw, ct, delta, dopamine, rp)
            m = g.edge_mask
            graphs[k] = g.replace_weights(torch.where(m, w, g.weights))
            traces[k] = dict(c=torch.where(m, c, tr["c"]),
                             dw=torch.where(m, dw, tr["dw"]),
                             counter=torch.where(m, ct, tr["counter"]))
        for ci, c in enumerate(rconns):
            rconn_ws[ci], rconn_tr[ci] = _conn_reward_update(
                c["op"].kind, c["op"].aux, rconn_ws[ci], rconn_tr[ci],
                c["static"], c["pre_plastic"], c["post_plastic"],
                vals_of(c["pre"], spikes), vals_of(c["post"], spikes),
                dopamine, rp)
        clock += 1
        for k in range(len(sts)):
            st_states[k], st_spk = st_model.step(st_states[k], generator,
                                                 clock - 1)
            st_states[k]["last_firing_time"] = \
                st_states[k]["last_firing_time"].masked_fill(st_spk,
                                                             clock - 1)
        for i, lat in hist:
            parts[("lat", i)].append(lat.grid_history.readout(
                states[lat_index[i]], (lat.rows, lat.cols)))
        for i, st in st_hist:
            parts[("st", i)].append(st.grid_history.readout(
                st_states[st_index[i]], (st.rows, st.cols)))
        for i in ghist:
            parts[("gw", i)].append(graphs[lat_index[i]].weights)
    ys = {key: torch.stack(x) for key, x in parts.items()}
    return (states, st_states, graphs, traces, conn_ws,
            list(zip(rconn_ws, rconn_tr)), float(dopamine), ys)

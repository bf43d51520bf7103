"""The structured network runners' plain route over row-sharded members.

PyTorch counterpart of running ``spiking_neural_networks_tpu/core/
structured.py`` on members that `parallel.shard_network` placed in row
blocks.  Each step follows `core.structured._plain_steps` (and, for a
reward network, `core.reward_structured._plain_reward_steps`) in the same
expression order:

* each member's intra gather runs per block: on a `StencilGraph` over the
  block's extended rows after a ghost refresh (state, and the weights of a
  plastic lattice), on a dense or sparse graph over the block's columns
  from the assembled presynaptic fields;
* each connection gathers from the presynaptic fields assembled from the
  source's blocks (a train's refractoriness effect, a lattice's v and
  neurotransmitters) into the whole destination, and each block adds its
  rows of every contribution in connection order;
* the model steps per block; the intra rule (STDP / BCM, R-STDP) updates
  each block's edges; a connection's rule updates its whole weights from
  the assembled post-step fields; trains step per block from one draw of
  each whole plane.

A member whose rows the mesh does not divide runs as one block on its own
device for the run.  The runners keep no kernel route on a sharded
network, as the JAX package keeps its Pallas kernels off a mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.plasticity import RewardModulatedSTDP, rule_tensors
from ..core.reward import modulate
from ..core.structured import (_chem_counts, _conn_edge_update, _conn_gather,
                               _conn_gather_chemical)
from ..models.base import get_neurotransmitter_concentrations
from ..models.spike_train import refractoriness_effect
from ..ops.graph import StencilGraph
from .lattice_sharding import shard_lattice, unshard_lattice
from .mesh import Mesh, device_array


class _Member:
    """One member's shards for a run: its blocks, whether they are stencil
    blocks (ghost rows) or column blocks, and the assembled fields of the
    current step."""

    def __init__(self, x):
        self.x = x
        self.temp = x.__dict__.get("_shard") is None
        if self.temp:
            mesh = x.mesh
            shard_lattice(x, Mesh(device_array([x.device]), ("tp",)))
            x.mesh = mesh
        self.sh = x._shard
        self.sh.sync(x)
        self.geom = self.sh.geom
        self.blocks = self.geom.local
        g = self.blocks[0].graph
        self.stencil = g is None or isinstance(g, StencilGraph)
        self.cols = self.sh.cols
        self.cache = {}

    def whole(self, key):
        """The whole leaf ``key`` of the current state, assembled once a
        step."""
        if key not in self.cache:
            self.cache[key] = self.sh._leaf(key)
        return self.cache[key]

    def new_step(self):
        self.cache = {}

    def rows_of(self, b, x):
        """Block ``b``'s extended rows of a whole (N, ...) tensor."""
        lo, hi = b.ext[0] * self.cols, b.ext[1] * self.cols
        return x[lo:hi].to(b.device)

    def pre_fields(self, b, keys):
        """The presynaptic fields a block's intra gather or rule reads: its
        own extended state on a stencil block, the assembled whole on a
        column block."""
        if self.stencil:
            return {k: b.state[k] for k in keys}
        return {k: self.whole(k).to(b.device) for k in keys}

    def finish(self):
        self.sh.done()
        if self.temp:
            mesh = self.x.mesh
            unshard_lattice(self.x)
            self.x.mesh = mesh


def _per_device(params):
    """``params`` as `rule_tensors` on a device, made once a device."""
    made = {}

    def on(dev):
        if dev not in made:
            made[dev] = rule_tensors(params, dev)
        return made[dev]
    return on


def _conn_contributions(net, plan, members, st_members, conn_ws, effects,
                        aux):
    """Every connection's whole electrical contribution and count, and
    chemical sums and counts, by destination lattice id, in connection
    order."""
    lat_index = {i: k for k, i in enumerate(plan["lat_ids"])}
    st_index = {i: k for k, i in enumerate(plan["st_ids"])}
    out = {i: [] for i in plan["lat_ids"]}
    for (meta, a), w in zip(aux, conn_ws):
        pre_id, post_id, kind, pre_is_st = meta
        dev = w.device
        v_post = members[lat_index[post_id]].whole("v").to(dev)
        if pre_is_st:
            src = st_members[st_index[pre_id]]
            a_src = effects[st_index[pre_id]].to(dev)
            sub = torch.zeros_like(a_src)
        else:
            src = members[lat_index[pre_id]]
            a_src = src.whole("v").to(dev)
            sub = torch.ones_like(a_src)
        elec = chem = None
        if net.electrical_synapse:
            elec = (_conn_gather(kind, a, w, a_src, sub, v_post),
                    a["in_deg"])
        if net.chemical_synapse:
            t, m = get_neurotransmitter_concentrations(
                {k: src.whole(k).to(dev)
                 for k in src.blocks[0].state if k.startswith("nt$")})
            chem = _conn_gather_chemical(kind, a, w, t, m.to(torch.float32))
        out[post_id].append((elec, chem))
    return out


def _phase_ab(net, model, members, contribs, lat_ids, skip_nt, clock):
    """Phase A per block (the intra gather, then each connection's rows)
    and phase B (the model step, the firing times); returns the spikes by
    (member, position)."""
    spikes = {}
    for k, (i, m) in enumerate(zip(lat_ids, members)):
        keys = ["v"] + ([key for key in m.blocks[0].state
                         if key.startswith("nt$")]
                        if net.chemical_synapse else [])
        for b in m.blocks:
            s, g = b.state, b.graph
            pre = m.pre_fields(b, keys)
            v, ones = s["v"], torch.ones_like(s["v"])
            if net.electrical_synapse:
                pv = pre["v"]
                total = g.gather_electrical(pv, torch.ones_like(pv), v, ones) \
                    * torch.clamp(g.in_degree(), min=1.0)
                cnt = g.in_degree()
            if net.chemical_synapse:
                t, mk = get_neurotransmitter_concentrations(pre)
                mk = mk.to(torch.float32)
                t_in, _ = g.gather_chemical(t, mk)
                gc = _chem_counts(g, mk)
                csum = t_in * torch.clamp(gc, min=1.0) * (gc > 0.0)
                ccnt = gc
            for elec, chem in contribs[i]:
                if elec is not None:
                    total = total + m.rows_of(b, elec[0])
                    cnt = cnt + m.rows_of(b, elec[1])
                if chem is not None:
                    csum = csum + m.rows_of(b, chem[0])
                    ccnt = ccnt + m.rows_of(b, chem[1])
            inputs = s["gap_conductance"] * total / torch.clamp(cnt, min=1.0) \
                if net.electrical_synapse else torch.zeros_like(v)
            if net.chemical_synapse:
                s, spk = model.step(s, inputs,
                                    csum / torch.clamp(ccnt, min=1.0),
                                    ccnt > 0.0, skip_nt=skip_nt)
            else:
                s, spk = model.step(s, inputs, skip_nt=skip_nt)
            s["last_firing_time"] = s["last_firing_time"].masked_fill(spk,
                                                                      clock)
            b.state = s
            spikes[(k, b.position)] = spk
        m.new_step()
    return spikes


def _step_trains(st_model, st_members, generator, clock):
    """Every train steps per block, with the pre-increment clock; a train
    that draws takes its rows of one draw of its whole plane."""
    for m in st_members:
        u = torch.rand((m.sh.n,), generator=generator,
                       device=generator.device) if st_model.needs_rng else None
        for b in m.blocks:
            kw = {} if u is None else {
                "u": u[b.own[0] * m.cols:b.own[1] * m.cols].to(b.device)}
            s, spk = st_model.step(b.state, generator, clock, **kw)
            s["last_firing_time"] = s["last_firing_time"].masked_fill(spk,
                                                                      clock)
            b.state = s
        m.new_step()


def _intra_rule(m, keys, delta):
    """Each block's intra edges take ``delta(w, pre, post)`` on the rule's
    fields ``keys`` (post-step): a stencil block its own extended fields
    at both ends, a column block the assembled sources and its own
    destinations."""
    for b in m.blocks:
        post = {k: b.state[k] for k in keys}
        b.graph = b.graph.apply_edge_update(delta, m.pre_fields(b, keys),
                                            post)


def _readouts(members, st_members, hist, st_hist, ghist, lat_index,
              st_index, parts):
    for i, lat in hist:
        m = members[lat_index[i]]
        parts[("lat", i)].append(lat.grid_history.readout(
            {"v": m.whole("v"), "is_spiking": m.whole("is_spiking")},
            (lat.rows, lat.cols)))
    for i, st in st_hist:
        m = st_members[st_index[i]]
        parts[("st", i)].append(st.grid_history.readout(
            {"v": m.whole("v"), "is_spiking": m.whole("is_spiking")},
            (st.rows, st.cols)))
    for i in ghist:
        m = members[lat_index[i]]
        parts[("gw", i)].append(m.sh._edges(lambda b: b.graph.weights))


def sharded_plain_steps(net, plan, length, skip_nt, hist, st_hist, ghist):
    """``length`` plain steps of a `LatticeNetwork` over its members'
    blocks (`core.structured._plain_steps`' expression order).  The blocks
    keep the states and graphs; returns (conn_ws, ys)."""
    lat_ids, st_ids, conns = plan["lat_ids"], plan["st_ids"], plan["conns"]
    lat_index = {i: k for k, i in enumerate(lat_ids)}
    st_index = {i: k for k, i in enumerate(st_ids)}
    lattices = [net.lattices[i] for i in lat_ids]
    sts = [net.spike_train_lattices[i] for i in st_ids]
    members = [_Member(x) for x in lattices]
    st_members = [_Member(x) for x in sts]
    model = lattices[0].model
    st_model = sts[0].model if sts else None
    do_plast = [bool(x.do_plasticity) for x in lattices]
    plasticity = net._plasticity()
    rule = type(plasticity)
    keys = rule.NODE_KEYS
    pp = _per_device(plasticity.params)
    aux = [((c["pre"], c["post"], c["op"].kind, c["pre_is_st"]),
            c["op"].aux) for c in conns]
    conn_ws = [c["op"].w0 for c in conns]
    generator = net.generator()
    parts = {("lat", i): [] for i, _ in hist}
    parts.update({("st", i): [] for i, _ in st_hist})
    parts.update({("gw", i): [] for i in ghist})
    clock = net.internal_clock

    def intra_delta(w, pre, post):
        return rule.apply_visits(
            w, pre, post, pp(w.device), pre["is_spiking"].to(torch.float32)
            + post["is_spiking"].to(torch.float32)) - w

    try:
        for _ in range(length):
            for k, m in enumerate(members):
                m.sh._refresh_state(("weights",) if do_plast[k] else ())
            effects = [m.geom.assemble(
                {b.position: refractoriness_effect(st_model.refractoriness,
                                                   b.state, clock)
                 for b in m.blocks}, m.geom.first_device)
                for m in st_members]
            contribs = _conn_contributions(net, plan, members, st_members,
                                           conn_ws, effects, aux)
            _phase_ab(net, model, members, contribs, lat_ids, skip_nt, clock)
            if any(do_plast):
                for k, m in enumerate(members):
                    if do_plast[k]:
                        _intra_rule(m, keys, intra_delta)
                for ci, (meta, a) in enumerate(aux):
                    pre_id, post_id, kind, pre_is_st = meta
                    post_k = lat_index[post_id]
                    pre_plastic = not pre_is_st \
                        and do_plast[lat_index[pre_id]]
                    if not (pre_plastic or do_plast[post_k]):
                        continue
                    dev = conn_ws[ci].device
                    src = st_members[st_index[pre_id]] if pre_is_st \
                        else members[lat_index[pre_id]]
                    state0 = src.blocks[0].state
                    pre_vals = {key: src.whole(key).to(dev) if key in state0
                                else torch.zeros_like(src.whole("v")).to(dev)
                                for key in keys}
                    post_vals = {key: members[post_k].whole(key).to(dev)
                                 for key in keys}

                    def gated_delta(w, pre, post, a=float(pre_plastic),
                                    b=float(do_plast[post_k])):
                        count = (pre["is_spiking"].to(torch.float32) * a
                                 + post["is_spiking"].to(torch.float32) * b)
                        return rule.apply_visits(w, pre, post, pp(w.device),
                                                 count) - w

                    conn_ws[ci] = _conn_edge_update(kind, a, conn_ws[ci],
                                                    gated_delta, pre_vals,
                                                    post_vals)
            clock += 1
            _step_trains(st_model, st_members, generator, clock - 1)
            _readouts(members, st_members, hist, st_hist, ghist, lat_index,
                      st_index, parts)
            for m in members:
                m.new_step()
    finally:
        for m in members + st_members:
            m.finish()
    return conn_ws, {key: torch.stack(p) for key, p in parts.items()}


def sharded_reward_steps(net, plan, rewards, with_reward, lat_kind, skip_nt,
                         hist, st_hist, ghist):
    """``len(rewards)`` plain steps of a `RewardModulatedLatticeNetwork`
    over its members' blocks (`core.reward_structured.
    _plain_reward_steps`' expression order; one dopamine scalar).  The
    blocks keep the states, graphs and traces; returns (conn_ws, rconns,
    dopamine, ys)."""
    from ..core.reward_structured import _conn_reward_update
    lattices_by_id = net._neuron_lattices()
    lat_ids, st_ids = plan["lat_ids"], plan["st_ids"]
    conns, rconns = plan["conns"], plan["rconns"]
    lat_index = {i: k for k, i in enumerate(lat_ids)}
    st_index = {i: k for k, i in enumerate(st_ids)}
    lattices = [lattices_by_id[i] for i in lat_ids]
    sts = [net.spike_train_lattices[i] for i in st_ids]
    members = [_Member(x) for x in lattices]
    st_members = [_Member(x) for x in sts]
    model = lattices[0].model
    st_model = sts[0].model if sts else None
    plasticity = net._plasticity()
    rule = type(plasticity)
    dev0 = members[0].geom.first_device
    pp = _per_device(plasticity.params)
    rp = _per_device(net.reward_modulator.params)

    conn_ws = [c["op"].w0 for c in conns]
    rconn_ws = [c["op"].w0 for c in rconns]
    rconn_tr = [dict(c["trace0"]) for c in rconns]
    aux = [((c["pre"], c["post"], c["op"].kind, c["pre_is_st"]),
            c["op"].aux) for c in conns + rconns]
    dopamine = torch.tensor(float(net.dopamine), dtype=torch.float32,
                            device=dev0)
    generator = net.generator()
    parts = {("lat", i): [] for i, _ in hist}
    parts.update({("st", i): [] for i, _ in st_hist})
    parts.update({("gw", i): [] for i in ghist})
    keys = tuple(dict.fromkeys(("last_firing_time", "is_spiking")
                               + rule.NODE_KEYS + ("trig",)))
    clock = net.internal_clock

    def vals_of(node_id, spikes, dev):
        """An endpoint's whole per-node fields (`_plain_reward_steps`'
        ``vals_of``)."""
        if node_id in st_index:
            m = st_members[st_index[node_id]]
            have = m.blocks[0].state
            zero = torch.zeros_like(m.whole("v")).to(dev)
            return {k: m.whole(k).to(dev) if k in have and k != "trig"
                    else zero for k in keys}
        k = lat_index[node_id]
        spk = spikes[k].to(dev)
        return {key: spk if key == "is_spiking"
                else spk.to(torch.float32) if key == "trig"
                else members[k].whole(key).to(dev) for key in keys}

    def intra_delta(w, pre, post):
        return rule.apply_visits(
            w, pre, post, pp(w.device),
            pre["is_spiking"].to(torch.float32)
            + post["is_spiking"].to(torch.float32)) - w

    try:
        for reward in torch.from_numpy(np.array(rewards, np.float32)):
            for kind, m in zip(lat_kind, members):
                m.sh._refresh_state({"plastic": ("weights",),
                                     "mod": ("weights", "trace")}
                                    .get(kind, ()))
            effects = [m.geom.assemble(
                {b.position: refractoriness_effect(st_model.refractoriness,
                                                   b.state, clock)
                 for b in m.blocks}, m.geom.first_device)
                for m in st_members]
            contribs = _conn_contributions(net, plan, members, st_members,
                                           conn_ws + rconn_ws, effects, aux)
            if with_reward:
                dopamine = RewardModulatedSTDP.update_dopamine(
                    dopamine, reward.to(dev0), rp(dev0))
            block_spikes = _phase_ab(net, model, members, contribs, lat_ids,
                                     skip_nt, clock)
            spikes = [m.geom.assemble(
                {b.position: m.sh._owned(b, block_spikes[(k, b.position)])
                 for b in m.blocks}, dev0).reshape(-1)
                for k, m in enumerate(members)]
            for kind, m in zip(lat_kind, members):
                if kind == "plastic":
                    _intra_rule(m, rule.NODE_KEYS, intra_delta)
            for ci, c in enumerate(conns):
                if not c["updates"]:
                    continue
                dev = conn_ws[ci].device

                def gated_delta(w, pre, post, c=c):
                    count = torch.full_like(w, float(c["static"]))
                    if c["pre_plastic"]:
                        count = count + pre["trig"]
                    if c["post_plastic"]:
                        count = count + post["trig"]
                    return rule.apply_visits(w, pre, post,
                                             pp(w.device),
                                             count) - w

                conn_ws[ci] = _conn_edge_update(
                    c["op"].kind, c["op"].aux, conn_ws[ci], gated_delta,
                    vals_of(c["pre"], spikes, dev),
                    vals_of(c["post"], spikes, dev))
            for kind, m in zip(lat_kind, members):
                if kind != "mod":
                    continue
                for b in m.blocks:
                    post = {"last_firing_time": b.state["last_firing_time"]}
                    b.graph, b.trace = modulate(
                        b.graph, b.trace,
                        m.pre_fields(b, ("last_firing_time",)), post,
                        dopamine.to(b.device), rp(b.device))
            for ci, c in enumerate(rconns):
                dev = rconn_ws[ci].device
                rconn_ws[ci], rconn_tr[ci] = _conn_reward_update(
                    c["op"].kind, c["op"].aux, rconn_ws[ci], rconn_tr[ci],
                    c["static"], c["pre_plastic"], c["post_plastic"],
                    vals_of(c["pre"], spikes, dev),
                    vals_of(c["post"], spikes, dev), dopamine.to(dev),
                    rp(dev))
            clock += 1
            _step_trains(st_model, st_members, generator, clock - 1)
            _readouts(members, st_members, hist, st_hist, ghist, lat_index,
                      st_index, parts)
            for m in members:
                m.new_step()
    finally:
        for m in members + st_members:
            m.finish()
    ys = {key: torch.stack(p) for key, p in parts.items()}
    return conn_ws, list(zip(rconn_ws, rconn_tr)), float(dopamine), ys

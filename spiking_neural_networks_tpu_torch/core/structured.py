"""Structure-preserving network runner.

PyTorch counterpart of ``spiking_neural_networks_tpu/core/structured.py``.
A network step is a sum of structured operators:

* intra-lattice synapses keep their graph backend (a `StencilGraph` stays
  a shifted-add stencil, a `DenseGraph` a float32 matrix product);
* inter-lattice connections are classified on the host: one-to-one ->
  elementwise ops; strided grid-to-grid (pooling, upsampling, shifted
  projections) -> `ResampleBlock` tap planes read by strided slices;
  small irregular blocks -> dense (pre.n, post.n) products; low in-degree
  blocks -> padded (post.n, K) gathers;
* every lattice steps on its own state dict.

Semantics as in the JAX package: the two-phase step, in-degree averaging
across every incoming component (per neurotransmitter type for chemical
synapses), deferred plasticity (the rule's ``apply_visits``, STDP or BCM)
with per-spiking-plastic-endpoint counts, clock sync, spike trains last.  `run_structured` runs either the network kernel
route (`ops.network_kernels`, K = 16 steps per call) or `_plain_steps`,
the plain PyTorch step loop in the XLA path's association.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.base import get_neurotransmitter_concentrations
from ..models.spike_train import refractoriness_effect
from ..ops.graph import DenseGraph, SparseGraph, exact_matmul
from .plasticity import rule_tensors
from .sharded import first_shard


# ---------------------------------------------------------------------------
# Connection operators (host-side builders; device data in ``w0``/``aux``)
# ---------------------------------------------------------------------------


def _dev(x, device):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


class OneToOne:
    """src[k] == dst[k] for every edge: an elementwise connection."""

    kind = "one2one"

    def __init__(self, src, dst, w, n, device="cpu"):
        self.dst_host = dst
        wv = np.zeros(n, np.float32)
        mv = np.zeros(n, bool)
        np.add.at(wv, dst, w)   # duplicate (src, dst) edges sum
        mv[dst] = True
        self.w0 = _dev(wv, device)
        self.aux = dict(mask=_dev(mv, device),
                        in_deg=_dev(mv.astype(np.float32), device))

    def extract(self, w):
        return w.cpu().numpy()[self.dst_host]

    def place(self, vals, dtype=np.float32):
        """Flat per-edge values (a reward connection's traces) in this
        operator's layout, on its device."""
        out = np.zeros(tuple(self.w0.shape), dtype)
        out[self.dst_host] = vals
        return _dev(out, self.w0.device)


class EmptyBlock:
    """A connection with no edges: zero contribution, O(n_post) state."""

    kind = "empty"

    def __init__(self, n_post, device="cpu"):
        self.w0 = torch.zeros(0, dtype=torch.float32, device=device)
        self.aux = dict(in_deg=torch.zeros(n_post, dtype=torch.float32,
                                           device=device))

    def extract(self, w):
        return np.zeros(0, np.float32)

    def place(self, vals, dtype=np.float32):
        return _dev(np.zeros(0, dtype), self.w0.device)


class DenseBlock:
    """A small irregular connection as a dense (n_pre, n_post) block."""

    kind = "dense"

    def __init__(self, src, dst, w, n_pre, n_post, device="cpu"):
        wv = np.zeros((n_pre, n_post), np.float32)
        mv = np.zeros((n_pre, n_post), bool)
        np.add.at(wv, (src, dst), w)
        mv[src, dst] = True
        self.src_host, self.dst_host = src, dst
        self.w0 = _dev(wv, device)
        self.aux = dict(mask=_dev(mv, device),
                        in_deg=_dev(mv.sum(axis=0).astype(np.float32),
                                    device))

    def extract(self, w):
        return w.cpu().numpy()[self.src_host, self.dst_host]

    def place(self, vals, dtype=np.float32):
        out = np.zeros(tuple(self.w0.shape), dtype)
        out[self.src_host, self.dst_host] = vals
        return _dev(out, self.w0.device)


class PaddedBlock:
    """A low in-degree connection as a (n_post, K) gather: index and weight
    per incoming slot, so plasticity is (n_post, K) elementwise too."""

    kind = "padded"
    MAX_K = 16

    def __init__(self, src, dst, w, n_pre, n_post, device="cpu"):
        counts = np.zeros(n_post, np.int64)
        np.add.at(counts, dst, 1)
        k_max = max(int(counts.max()), 1)
        idx = np.zeros((n_post, k_max), np.int64)
        wv = np.zeros((n_post, k_max), np.float32)
        mv = np.zeros((n_post, k_max), bool)
        slot = np.zeros(n_post, np.int64)
        self.edge_slots = np.empty(len(src), np.int64)  # flat j * K + k
        for e, (i, j) in enumerate(zip(src, dst)):
            k = slot[j]
            idx[j, k] = i
            wv[j, k] = w[e]
            mv[j, k] = True
            self.edge_slots[e] = j * k_max + k
            slot[j] += 1
        self.w0 = _dev(wv, device)
        self.aux = dict(mask=_dev(mv, device), idx=_dev(idx, device),
                        in_deg=_dev(counts.astype(np.float32), device))

    def extract(self, w):
        return w.cpu().numpy().reshape(-1)[self.edge_slots]

    def place(self, vals, dtype=np.float32):
        out = np.zeros(tuple(self.w0.shape), dtype).reshape(-1)
        out[self.edge_slots] = vals
        return _dev(out.reshape(tuple(self.w0.shape)), self.w0.device)


class ResampleBlock:
    """A strided grid-to-grid connection (pooling, upsampling, shifted
    same-size projection), detected from the COO edge list.

    Post position (r, c) reads ``pre(f(r) + dr, f(c) + dc)`` over a small
    static tap set, where f is ``r * stride`` (down) or ``r // factor``
    (up) per axis.  Weights and masks are (n_taps, R2, C2) planes; the
    gather is strided slices of a zero-padded plane, no index gathers.
    """

    MAX_TAPS = 64

    def __init__(self, src, dst, w, shapes, fr, fc, taps, dr, dc,
                 device="cpu"):
        R1, C1, R2, C2 = shapes
        self.static = (R1, C1, R2, C2, int(fr), int(fc),
                       tuple((int(a), int(b)) for a, b in taps))
        self.kind = ("resample",) + self.static
        tap_index = {(int(a), int(b)): t for t, (a, b) in enumerate(taps)}
        tr, tc = dst // C2, dst % C2
        ti = np.array([tap_index[(int(a), int(b))] for a, b in zip(dr, dc)])
        wv = np.zeros((len(taps), R2, C2), np.float32)
        mv = np.zeros((len(taps), R2, C2), bool)
        np.add.at(wv, (ti, tr, tc), w)
        mv[ti, tr, tc] = True
        self._edge_idx = (ti, tr, tc)
        self.w0 = _dev(wv, device)
        self.aux = dict(mask=_dev(mv, device),
                        in_deg=_dev(mv.sum(axis=0).reshape(-1)
                                    .astype(np.float32), device))

    def extract(self, w):
        ti, tr, tc = self._edge_idx
        return w.cpu().numpy()[ti, tr, tc]

    def place(self, vals, dtype=np.float32):
        out = np.zeros(tuple(self.w0.shape), dtype)
        out[self._edge_idx] = vals
        return _dev(out, self.w0.device)


def _detect_resample(src, dst, n_pre, n_post, pre_shape, post_shape,
                     max_taps=ResampleBlock.MAX_TAPS):
    """The edge list as a strided or upsampled tap set, or None."""
    if pre_shape is None or post_shape is None or len(src) == 0:
        return None
    R1, C1 = pre_shape
    R2, C2 = post_shape
    if R1 * C1 != n_pre or R2 * C2 != n_post or not (R1 and C1 and R2 and C2):
        return None

    def factor(n1, n2):
        if n1 % n2 == 0:
            return n1 // n2       # positive: down-stride
        if n2 % n1 == 0:
            return -(n2 // n1)    # negative: up-repeat factor
        return None

    fr, fc = factor(R1, R2), factor(C1, C2)
    if fr is None or fc is None:
        return None
    sr, sc = src // C1, src % C1
    tr, tc = dst // C2, dst % C2
    dr = sr - (tr * fr if fr > 0 else tr // -fr)
    dc = sc - (tc * fc if fc > 0 else tc // -fc)
    taps = np.unique(np.stack([dr, dc], axis=1), axis=0)
    if len(taps) > max_taps:
        return None
    # a scattered edge set that happens to fit a tap decomposition would
    # pay full-plane traffic for almost-empty planes: cap the blow-up
    if len(taps) * n_post > 64 * len(src):
        return None
    return fr, fc, taps, dr, dc


def _resample_pad(static):
    (R1, C1, R2, C2, fr, fc, taps) = static
    pr = max((abs(t[0]) for t in taps), default=0)
    pc = max((abs(t[1]) for t in taps), default=0)
    return pr, pc


def _resample_planes(static, x):
    """Pre-grid values x (n_pre, ...) -> per-tap post-aligned planes
    (n_taps, R2, C2, ...) from a zero-padded copy by strided slices and
    row/column repeats."""
    (R1, C1, R2, C2, fr, fc, taps) = static
    pr, pc = _resample_pad(static)
    trailing = tuple(x.shape[1:])
    xp = x.new_zeros((R1 + 2 * pr, C1 + 2 * pc) + trailing)
    xp[pr:pr + R1, pc:pc + C1] = x.reshape((R1, C1) + trailing)

    def tap_plane(dr, dc):
        if fr > 0:
            y = xp[pr + dr:pr + dr + fr * (R2 - 1) + 1:fr]
        else:
            y = xp[pr + dr:pr + dr + R1].repeat_interleave(-fr, dim=0)
        if fc > 0:
            y = y[:, pc + dc:pc + dc + fc * (C2 - 1) + 1:fc]
        else:
            y = y[:, pc + dc:pc + dc + C1].repeat_interleave(-fc, dim=1)
        return y

    return torch.stack([tap_plane(dr, dc) for dr, dc in taps])


PADDED_MIN_ENTRIES = 1_000_000           # plastic blocks: padded above this
DENSE_MAX_ENTRIES = 32 * 1024 * 1024     # static blocks: dense up to 128 MB


def classify_connection(src, dst, w, n_pre, n_post, plastic=True,
                        pre_shape=None, post_shape=None, device="cpu"):
    """The operator of one connection's COO edge list: empty, one-to-one,
    resample, padded or dense, chosen as the JAX package chooses."""
    if len(src) == 0:
        return EmptyBlock(n_post, device)
    if len(src) <= n_post and n_pre == n_post and (src == dst).all():
        return OneToOne(src, dst, w, n_post, device)
    res = _detect_resample(src, dst, n_pre, n_post, pre_shape, post_shape)
    if res is not None:
        fr, fc, taps, dr, dc = res
        return ResampleBlock(src, dst, w, tuple(pre_shape) + tuple(post_shape),
                             fr, fc, taps, dr, dc, device)
    counts = np.zeros(n_post, np.int64)
    np.add.at(counts, dst, 1)
    threshold = PADDED_MIN_ENTRIES if plastic else DENSE_MAX_ENTRIES
    if counts.max() <= PaddedBlock.MAX_K and n_pre * n_post > threshold:
        return PaddedBlock(src, dst, w, n_pre, n_post, device)
    if n_pre * n_post > DENSE_MAX_ENTRIES:
        return PaddedBlock(src, dst, w, n_pre, n_post, device)
    return DenseBlock(src, dst, w, n_pre, n_post, device)


def _conn_gather(kind, aux, w, a_src, sub_src, v_post):
    """The summed electrical contribution ``sum w * (a - sub * v)`` of one
    connection to each post cell, in the XLA path's association."""
    if kind == "empty":
        return torch.zeros_like(v_post)
    if kind == "one2one":
        return torch.where(aux["mask"], w * (a_src - sub_src * v_post), 0.0)
    if isinstance(kind, tuple):  # ("resample", *static)
        static = kind[1:]
        R2, C2 = static[2], static[3]
        pair = _resample_planes(static, torch.stack([a_src, sub_src], dim=-1))
        contrib = w * (pair[..., 0] - pair[..., 1] * v_post.reshape(1, R2, C2))
        acc = torch.zeros_like(contrib[0])
        for t in range(contrib.shape[0]):
            acc = acc + contrib[t]
        return acc.reshape(-1)
    if kind == "padded":
        pair = torch.stack([a_src, sub_src], dim=-1)[aux["idx"]]
        contrib = torch.where(aux["mask"],
                              w * (pair[..., 0] - pair[..., 1]
                                   * v_post[:, None]), 0.0)
        return torch.sum(contrib, dim=1)
    return exact_matmul(a_src, w) - v_post * exact_matmul(sub_src, w)


def _conn_gather_chemical(kind, aux, w, t_src, m_src):
    """The per-type (n_post, K) sums ``w * t * m`` and counts ``m`` of one
    connection's present sources, in the XLA path's association."""
    if kind == "empty":
        z = t_src.new_zeros((aux["in_deg"].shape[0], t_src.shape[-1]))
        return z, z
    if kind == "one2one":
        gate = aux["mask"][:, None]
        return (torch.where(gate, w[:, None] * t_src * m_src, 0.0),
                torch.where(gate, m_src, 0.0))
    if isinstance(kind, tuple):  # ("resample", *static)
        T = t_src.shape[-1]
        both = _resample_planes(kind[1:], torch.cat([t_src * m_src, m_src],
                                                    dim=-1))
        gate = aux["mask"][..., None]
        tm = torch.where(gate, w[..., None] * both[..., :T], 0.0)
        mm = torch.where(gate, both[..., T:], 0.0)
        sums, cnts = torch.zeros_like(tm[0]), torch.zeros_like(mm[0])
        for t in range(tm.shape[0]):
            sums = sums + tm[t]
            cnts = cnts + mm[t]
        return sums.reshape(-1, T), cnts.reshape(-1, T)
    if kind == "padded":
        T = t_src.shape[-1]
        both = torch.cat([t_src * m_src, m_src], dim=-1)[aux["idx"]]
        gate = aux["mask"][:, :, None]
        return (torch.sum(torch.where(gate, w[:, :, None] * both[..., :T],
                                      0.0), dim=1),
                torch.sum(torch.where(gate, both[..., T:], 0.0), dim=1))
    return (exact_matmul(w.T, t_src * m_src),
            exact_matmul(aux["mask"].to(torch.float32).T, m_src))


def _chem_counts(graph, m_src):
    """Per-type (n_post, K) counts of a lattice graph's present sources,
    which turn its averaged chemical gather back into sums."""
    if isinstance(graph, DenseGraph):
        return exact_matmul(graph.mask.to(torch.float32).T, m_src)
    if isinstance(graph, SparseGraph):
        return m_src.new_zeros((graph.n_post, m_src.shape[-1])).index_add(
            0, graph.dst, m_src[graph.src])
    rows, cols = graph.shape
    k = m_src.shape[-1]
    mp = graph._padded(m_src.reshape(rows, cols, k))
    cnts = m_src.new_zeros((rows, cols, k))
    for o, (dr, dc) in enumerate(graph.offsets):
        cnts = cnts + graph.mask[o][:, :, None] * graph._shifted(mp, dr, dc)
    return cnts.reshape(-1, k)


def _edge_layout(kind, aux, pre_vals, post_vals):
    """Per-node value dicts broadcast into the connection's edge layout;
    resampled and gathered pre fields are cast to float32 (exact for
    firing times below 2^24 steps)."""
    if kind == "one2one":
        return dict(pre_vals), dict(post_vals)
    keys = list(pre_vals)
    if isinstance(kind, tuple):  # ("resample", *static)
        static = kind[1:]
        R2, C2 = static[2], static[3]
        stacked = _resample_planes(
            static, torch.stack([pre_vals[k].to(torch.float32)
                                 for k in keys], dim=-1))
        pre = {k: stacked[..., f] for f, k in enumerate(keys)}
        post = {k: v.reshape(1, R2, C2) for k, v in post_vals.items()}
        return pre, post
    if kind == "padded":
        stacked = torch.stack([pre_vals[k].to(torch.float32) for k in keys],
                              dim=-1)[aux["idx"]]
        pre = {k: stacked[..., f] for f, k in enumerate(keys)}
        post = {k: v[:, None] for k, v in post_vals.items()}
        return pre, post
    pre = {k: v[:, None] for k, v in pre_vals.items()}
    post = {k: v[None, :] for k, v in post_vals.items()}
    return pre, post


def _conn_edge_update(kind, aux, w, delta_fn, pre_vals, post_vals):
    if kind == "empty":
        return w
    pre, post = _edge_layout(kind, aux, pre_vals, post_vals)
    dw = delta_fn(w, pre, post)
    return torch.where(aux["mask"], w + dw, w)


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------


def compile_structured(net):
    """The plan: sorted lattice and train ids and every connection's
    operator, in ``sorted(net.connections)`` order."""
    lat_ids = sorted(net.lattices)
    st_ids = sorted(net.spike_train_lattices)
    conns = []
    for (pre_id, post_id), (src, dst, w) in sorted(net.connections.items()):
        pre = net.lattices.get(pre_id) or net.spike_train_lattices.get(pre_id)
        post = net.lattices[post_id]
        pre_is_st = pre_id in net.spike_train_lattices
        plastic = bool(post.do_plasticity) or (
            not pre_is_st and bool(pre.do_plasticity))
        op = classify_connection(np.asarray(src), np.asarray(dst),
                                 np.asarray(w), pre.n, post.n, plastic,
                                 pre_shape=(pre.rows, pre.cols),
                                 post_shape=(post.rows, post.cols),
                                 device=post.device)
        conns.append(dict(pre=pre_id, post=post_id, op=op,
                          pre_is_st=pre_is_st, plastic=plastic,
                          key=(pre_id, post_id)))
    return dict(lat_ids=lat_ids, st_ids=st_ids, conns=conns)


def resolve_structured_plan(net):
    """The cached plan, rebuilt when the connection version or the
    per-lattice plasticity flags changed."""
    plast_key = tuple(bool(net.lattices[i].do_plasticity)
                      for i in sorted(net.lattices))
    version = (net._conn_version, plast_key)
    cached = net._structured_plan
    if cached is not None and cached[0] == version:
        return cached[1]
    plan = compile_structured(net)
    net._structured_plan = (version, plan)
    return plan


def nt_flags(net, plan):
    """Whether each lattice, then each train, in plan order, has a
    neurotransmitter inserted (the step never writes the masks, so a run
    reads them once)."""
    return tuple(bool(x.state["nt$mask"].any()) for x in
                 [net.lattices[i] for i in plan["lat_ids"]]
                 + [net.spike_train_lattices[i] for i in plan["st_ids"]])


def run_structured(net, iterations, flags):
    """Advance the network ``iterations`` steps over the kernel route or
    the plain route, write the states, graphs and connection weights back,
    and extend the histories.  ``flags`` are `nt_flags`: the lattices skip
    the neurotransmitter update when none of them has one inserted."""
    from ..ops import network_kernels as nk
    plan = resolve_structured_plan(net)
    lattices = [net.lattices[i] for i in plan["lat_ids"]]
    sts = [net.spike_train_lattices[i] for i in plan["st_ids"]]
    skip_nt = not any(flags[:len(lattices)])
    st_nt = flags[len(lattices):]
    hist = [(i, l) for i, l in zip(plan["lat_ids"], lattices)
            if l.update_grid_history]
    st_hist = [(i, s) for i, s in zip(plan["st_ids"], sts)
               if s.update_grid_history]
    ghist = [i for i, l in zip(plan["lat_ids"], lattices)
             if l.update_graph_history]
    shards = first_shard(lattices + sts)
    sharded = shards is not None
    spec = None
    if net.use_kernel is not False and not sharded:
        spec = nk.plain_network_spec(net, plan, skip_nt and not any(st_nt),
                                     st_nt)
        if spec is not None and net.use_kernel is None \
                and not lattices[0].state["v"].is_cuda:
            spec = None
    if sharded:
        # the blocks keep the states and graphs
        conn_ws, ys = shards.network_steps(net, plan, int(iterations),
                                           skip_nt, hist, st_hist, ghist)
        states = st_states = graphs = ()
        net._last_run_fused = False
    elif spec is not None:
        states, st_states, graphs, conn_ws, ys, _ = nk.advance(
            spec, net, plan, int(iterations))
        tag = ("flat-chemical" if spec.chem else "flat") if nk.is_flat(spec) \
            else ("chemical" if spec.chem else "network")
        net._last_run_fused = (tag, any(ls.emit for ls in spec.lattices))
    else:
        states, st_states, graphs, conn_ws, ys = _plain_steps(
            net, plan, int(iterations), skip_nt, hist, st_hist, ghist)
        net._last_run_fused = False
    net.internal_clock += iterations
    for lat, state, graph in zip(lattices, states, graphs):
        lat.state = dict(state)
        lat.graph = graph
    for st, state in zip(sts, st_states):
        st.state = dict(state)
    for x in lattices + sts:
        x.internal_clock = net.internal_clock
    for c, w in zip(plan["conns"], conn_ws):
        c["op"].w0 = w
    for i, lat in hist:
        lat.grid_history.extend(ys[("lat", i)].cpu())
    for i, st in st_hist:
        st.grid_history.extend(ys[("st", i)].cpu())
    for i in ghist:
        net.lattices[i].graph_history.extend(ys[("gw", i)].cpu().numpy())


def write_back_connections(net):
    """The host COO mirror of every plastic connection from its device
    weights (the mirror stays the user-visible source of truth; the plan
    cache keeps its version)."""
    if net._structured_plan is None:
        return
    for c in net._structured_plan[1]["conns"]:
        if c["plastic"]:
            src, dst, _ = net.connections[c["key"]]
            net.connections[c["key"]] = (src, dst, c["op"].extract(c["op"].w0))


# ---------------------------------------------------------------------------
# The plain route: a Python step loop
# ---------------------------------------------------------------------------


def _phase_a(lat_ids, lat_index, st_index, states, st_states, graphs, conns,
             effects, electrical, chemical):
    """Per-lattice inputs (phase A), each the intra gather re-expanded to
    sums plus every connection targeting the lattice: the electrical input
    averaged over the total in-degree (zeros without electrical synapses),
    and with ``chemical`` the per-type neurotransmitter sums and counts.
    ``conns`` is a sequence of ((pre_id, post_id, kind, pre_is_st), aux, w)
    triples.  Returns (inputs, chem_sums, chem_cnts)."""
    inputs, chem_sums, chem_cnts = [], [], []
    for k, i in enumerate(lat_ids):
        s = states[k]
        v = s["v"]
        g = graphs[k]
        if electrical:
            ones = torch.ones_like(v)
            total = g.gather_electrical(v, ones, v, ones) \
                * torch.clamp(g.in_degree(), min=1.0)
            cnt = g.in_degree()
        if chemical:
            t, m = get_neurotransmitter_concentrations(s)
            m = m.to(torch.float32)
            t_in, _ = g.gather_chemical(t, m)
            gc = _chem_counts(g, m)
            csum = t_in * torch.clamp(gc, min=1.0) * (gc > 0.0)
            ccnt = gc
        for (pre_id, post_id, kind, pre_is_st), aux, w in conns:
            if post_id != i:
                continue
            if pre_is_st:
                src = st_states[st_index[pre_id]]
                a_src = effects[st_index[pre_id]]
                sub = torch.zeros_like(a_src)
            else:
                src = states[lat_index[pre_id]]
                a_src = src["v"]
                sub = torch.ones_like(a_src)
            if electrical:
                total = total + _conn_gather(kind, aux, w, a_src, sub, v)
                cnt = cnt + aux["in_deg"]
            if chemical:
                t, m = get_neurotransmitter_concentrations(src)
                sums, cnts = _conn_gather_chemical(kind, aux, w, t,
                                                   m.to(torch.float32))
                csum = csum + sums
                ccnt = ccnt + cnts
        inputs.append(s["gap_conductance"] * total / torch.clamp(cnt, min=1.0)
                      if electrical else torch.zeros_like(v))
        if chemical:
            chem_sums.append(csum)
            chem_cnts.append(ccnt)
    return inputs, chem_sums, chem_cnts


def _phase_b(model, states, inputs, chem_sums, chem_cnts, skip_nt, clock):
    """Step every lattice with ``model`` (phase B; the chemical input is
    ``sums / max(cnts, 1)``, valid where ``cnts > 0``) and stamp the
    firing times."""
    out_states, spikes = [], []
    for k in range(len(states)):
        if chem_sums:
            t_in = chem_sums[k] / torch.clamp(chem_cnts[k], min=1.0)
            s, spk = model.step(states[k], inputs[k], t_in,
                                chem_cnts[k] > 0.0, skip_nt=skip_nt)
        else:
            s, spk = model.step(states[k], inputs[k], skip_nt=skip_nt)
        s["last_firing_time"] = s["last_firing_time"].masked_fill(spk, clock)
        out_states.append(s)
        spikes.append(spk)
    return out_states, spikes


def _plain_steps(net, plan, length, skip_nt, hist, st_hist, ghist):
    """``length`` plain PyTorch network steps from the members' states.
    Returns (states, st_states, graphs, conn_ws, ys) with ys the stacked
    per-step history readouts keyed ("lat", id), ("st", id), ("gw", id)."""
    lat_ids, st_ids, conns = plan["lat_ids"], plan["st_ids"], plan["conns"]
    lat_index = {i: k for k, i in enumerate(lat_ids)}
    st_index = {i: k for k, i in enumerate(st_ids)}
    lattices = [net.lattices[i] for i in lat_ids]
    sts = [net.spike_train_lattices[i] for i in st_ids]
    model = lattices[0].model
    st_model = sts[0].model if sts else None
    do_plast = [bool(l.do_plasticity) for l in lattices]
    plasticity = net._plasticity()
    rule = type(plasticity)
    pparams = rule_tensors(plasticity.params, lattices[0].device)
    meta = [(c["pre"], c["post"], c["op"].kind, c["pre_is_st"])
            for c in conns]
    aux = [c["op"].aux for c in conns]
    states = [l.state for l in lattices]
    st_states = [s.state for s in sts]
    graphs = [l.graph for l in lattices]
    conn_ws = [c["op"].w0 for c in conns]
    generator = net.generator()
    keys = rule.NODE_KEYS
    parts = {("lat", i): [] for i, _ in hist}
    parts.update({("st", i): [] for i, _ in st_hist})
    parts.update({("gw", i): [] for i in ghist})
    clock = net.internal_clock
    for _ in range(length):
        effects = [refractoriness_effect(st_model.refractoriness, s, clock)
                   for s in st_states]
        inputs, chem_sums, chem_cnts = _phase_a(
            lat_ids, lat_index, st_index, states, st_states, graphs,
            list(zip(meta, aux, conn_ws)), effects, net.electrical_synapse,
            net.chemical_synapse)
        states, _ = _phase_b(model, states, inputs, chem_sums, chem_cnts,
                             skip_nt, clock)
        if any(do_plast):
            for k in range(len(lattices)):
                if not do_plast[k]:
                    continue
                vals = {key: states[k][key] for key in keys}
                graphs[k] = graphs[k].apply_edge_update(
                    lambda w, pre, post: rule.apply_visits(
                        w, pre, post, pparams,
                        pre["is_spiking"].to(torch.float32)
                        + post["is_spiking"].to(torch.float32)) - w,
                    vals, vals)
            for ci, (pre_id, post_id, kind, pre_is_st) in enumerate(meta):
                post_k = lat_index[post_id]
                pre_plastic = not pre_is_st and do_plast[lat_index[pre_id]]
                post_plastic = do_plast[post_k]
                if not (pre_plastic or post_plastic):
                    continue
                src_state = st_states[st_index[pre_id]] if pre_is_st \
                    else states[lat_index[pre_id]]
                # a train may lack a rule's node field (BCM's activities
                # on a Poisson train): zeros, as the flat runner pads
                zero = torch.zeros_like(src_state["v"])
                pre_vals = {key: src_state.get(key, zero) for key in keys}
                post_vals = {key: states[post_k][key] for key in keys}

                def gated_delta(w, pre, post, pre_plastic=pre_plastic,
                                post_plastic=post_plastic):
                    count = (pre["is_spiking"].to(torch.float32)
                             * (1.0 if pre_plastic else 0.0)
                             + post["is_spiking"].to(torch.float32)
                             * (1.0 if post_plastic else 0.0))
                    return rule.apply_visits(w, pre, post, pparams,
                                             count) - w

                conn_ws[ci] = _conn_edge_update(kind, aux[ci], conn_ws[ci],
                                                gated_delta, pre_vals,
                                                post_vals)
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
    ys = {key: torch.stack(p) for key, p in parts.items()}
    return states, st_states, graphs, conn_ws, ys

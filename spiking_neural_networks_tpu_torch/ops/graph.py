"""Synaptic connectivity graphs and their input gathers.

PyTorch counterpart of ``spiking_neural_networks_tpu/ops/graph.py``:
:class:`DenseGraph` ((n_pre, n_post) weight and mask matrices; the gathers
are float32 matrix products), :class:`SparseGraph` (COO edge list, its
electrical and chemical gathers, edge updates and per-edge edits),
:func:`radius_offsets`, :class:`StencilGraph` (per-destination, per-offset
weight planes on a (rows, cols) grid), the host constructors of
``connect(predicate)``, which decompose a pairwise predicate into a
`StencilGraph` where its offset support is narrow and keep a `DenseGraph`
where it is wide, and the converters between the three layouts.

Graph construction runs in host NumPy, drawing the same random numbers in
the same order as the JAX package, and moves the result to the device once.

Electrical input to j (in-degree averaged, as in the reference):
    g_j * sum_i w_ij * (a_i - sub_i * v_j) / max(indegree_j, 1)
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _check_node(idx, n):
    if not (0 <= idx < n):
        from ..errors import GraphError
        raise GraphError(f"position {idx} not in graph (n={n})")


def exact_matmul(a, b):
    """``a @ b`` in full float32, as the JAX package's gathers take their
    products.  On a GPU it raises where the process allows TF32 for
    float32 products (PyTorch's default does not); it changes no global
    setting."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the dense gathers need full float32 products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    return a @ b


# ---------------------------------------------------------------------------
# Dense graph
# ---------------------------------------------------------------------------


class DenseGraph:
    """Dense (n_pre, n_post) float32 weight matrix; ``mask[i, j]`` (bool)
    marks the edge i -> j."""

    def __init__(self, weights, mask):
        self.weights = weights
        self.mask = mask

    @classmethod
    def empty(cls, n_pre, n_post=None, device="cpu"):
        n_post = n_pre if n_post is None else n_post
        return cls(torch.zeros((n_pre, n_post), dtype=torch.float32,
                               device=device),
                   torch.zeros((n_pre, n_post), dtype=torch.bool,
                               device=device))

    @property
    def n_pre(self):
        return self.weights.shape[0]

    @property
    def n_post(self):
        return self.weights.shape[1]

    @property
    def has_edges(self):
        """Whether the mask holds any edge (one read from the device; not
        cached, since ``mask`` may be edited in place)."""
        return bool(self.mask.any())

    def in_degree(self):
        return torch.sum(self.mask.to(torch.float32), dim=0)

    def _masked(self):
        return torch.where(self.mask, self.weights, 0.0)

    # -- gathers ------------------------------------------------------------
    def gather_electrical(self, a_src, sub_v, v_post, g_post):
        """``g * (a @ w - v * (sub @ w)) / max(in_deg, 1)`` over the masked
        weights."""
        w = self._masked()
        wa = exact_matmul(a_src, w)
        wsub = exact_matmul(sub_v, w)
        cnt = torch.clamp(self.in_degree(), min=1.0)
        return g_post * (wa - v_post * wsub) / cnt

    def gather_chemical(self, t_src, nt_mask_src):
        """Per-type (n_post, K) neurotransmitter input ``sums / max(cnts,
        1)`` with ``sums = w.T @ (t * m)`` and ``cnts = mask.T @ m``, and
        ``cnts > 0`` as its validity."""
        sums = exact_matmul(self._masked().T, t_src * nt_mask_src)
        cnts = exact_matmul(self.mask.to(torch.float32).T, nt_mask_src)
        return sums / torch.clamp(cnts, min=1.0), cnts > 0.0

    # -- per-edge updates (plasticity) --------------------------------------
    def edge_pre_post(self, pre_vals, post_vals):
        """Per-node value dicts broadcast to the (n_pre, n_post) edge
        plane."""
        pre = {k: v[:, None] for k, v in pre_vals.items()}
        post = {k: v[None, :] for k, v in post_vals.items()}
        return pre, post

    @property
    def edge_mask(self):
        return self.mask

    def replace_weights(self, weights):
        return DenseGraph(weights, self.mask)

    def apply_edge_update(self, edge_dw, pre_vals, post_vals):
        """``w + edge_dw(w, pre, post)`` on every edge the mask holds."""
        pre, post = self.edge_pre_post(pre_vals, post_vals)
        dw = edge_dw(self.weights, pre, post)
        return self.replace_weights(
            torch.where(self.mask, self.weights + dw, self.weights))

    # -- per-edge access ----------------------------------------------------
    def lookup_weight(self, src, dst):
        _check_node(src, self.n_pre)
        _check_node(dst, self.n_post)
        if not bool(self.mask[src, dst]):
            return None
        return float(self.weights[src, dst])

    def edit_weight(self, src, dst, w):
        """A graph with edge src -> dst set to ``w``, or removed when ``w``
        is None."""
        _check_node(src, self.n_pre)
        _check_node(dst, self.n_post)
        weights, mask = self.weights.clone(), self.mask.clone()
        weights[src, dst] = 0.0 if w is None else w
        mask[src, dst] = w is not None
        return DenseGraph(weights, mask)

    def get_incoming_connections(self, dst):
        _check_node(dst, self.n_post)
        return set(torch.nonzero(self.mask[:, dst]).reshape(-1).tolist())

    def get_outgoing_connections(self, src):
        _check_node(src, self.n_pre)
        return set(torch.nonzero(self.mask[src, :]).reshape(-1).tolist())


# ---------------------------------------------------------------------------
# Sparse COO graph
# ---------------------------------------------------------------------------


class SparseGraph:
    """COO edge list: ``src``, ``dst`` int64 (E,), ``weights`` f32 (E,),
    with the per-destination in-degree ``in_deg`` f32 (n_post,)."""

    def __init__(self, src, dst, weights, n_pre, n_post, in_deg=None):
        self.src = src
        self.dst = dst
        self.weights = weights
        self.n_pre = int(n_pre)
        self.n_post = int(n_post)
        if in_deg is None:
            in_deg = torch.zeros(self.n_post, dtype=torch.float32,
                                 device=weights.device).index_add_(
                0, dst, torch.ones_like(weights))
        self.in_deg = in_deg

    @classmethod
    def from_arrays(cls, src, dst, weights, n_pre, n_post=None, device="cpu"):
        """A graph from host edge arrays, stably sorted by destination."""
        n_post = n_pre if n_post is None else n_post
        order = np.argsort(np.asarray(dst), kind="stable")
        return cls(
            torch.from_numpy(np.asarray(src)[order].astype(np.int64)).to(device),
            torch.from_numpy(np.asarray(dst)[order].astype(np.int64)).to(device),
            torch.from_numpy(
                np.asarray(weights)[order].astype(np.float32)).to(device),
            n_pre, n_post)

    @classmethod
    def empty(cls, n_pre, n_post=None, device="cpu"):
        """Zero-edge graph: the default of a freshly populated lattice."""
        n_post = n_pre if n_post is None else n_post
        idx = torch.zeros(0, dtype=torch.int64, device=device)
        return cls(idx, idx.clone(),
                   torch.zeros(0, dtype=torch.float32, device=device),
                   n_pre, n_post,
                   torch.zeros(n_post, dtype=torch.float32, device=device))

    def in_degree(self):
        return self.in_deg

    def gather_electrical(self, a_src, sub_v, v_post, g_post):
        contrib = self.weights * (a_src[self.src]
                                  - sub_v[self.src] * v_post[self.dst])
        summed = torch.zeros(self.n_post, dtype=contrib.dtype,
                             device=contrib.device).index_add_(
            0, self.dst, contrib)
        cnt = torch.clamp(self.in_deg, min=1.0)
        return g_post * summed / cnt

    def gather_chemical(self, t_src, nt_mask_src):
        """Per-type (n_post, K) neurotransmitter input: the weighted sum of
        the present sources' concentrations over their count, and where
        that count is above 0."""
        m = nt_mask_src[self.src]
        vals = self.weights[:, None] * t_src[self.src] * m
        zeros = torch.zeros((self.n_post, t_src.shape[-1]),
                            dtype=torch.float32, device=t_src.device)
        sums = zeros.index_add(0, self.dst, vals)
        cnts = zeros.index_add(0, self.dst, m)
        return sums / torch.clamp(cnts, min=1.0), cnts > 0.0

    # -- per-edge updates (plasticity) ------------------------------------------
    def edge_pre_post(self, pre_vals, post_vals):
        pre = {k: v[self.src] for k, v in pre_vals.items()}
        post = {k: v[self.dst] for k, v in post_vals.items()}
        return pre, post

    @property
    def edge_mask(self):
        return torch.ones_like(self.weights, dtype=torch.bool)

    def replace_weights(self, weights):
        return SparseGraph(self.src, self.dst, weights, self.n_pre,
                           self.n_post, self.in_deg)

    # -- per-edge access ----------------------------------------------------------
    def _edge_index(self, src, dst):
        hits = np.nonzero((self.src.cpu().numpy() == src)
                          & (self.dst.cpu().numpy() == dst))[0]
        return int(hits[0]) if len(hits) else None

    def lookup_weight(self, src, dst):
        _check_node(src, self.n_pre)
        _check_node(dst, self.n_post)
        e = self._edge_index(src, dst)
        return None if e is None else float(self.weights[e])

    def edit_weight(self, src, dst, w):
        """A graph with edge src -> dst set to ``w`` (added if missing), or
        removed when ``w`` is None; an added or removed edge re-sorts the
        list by destination."""
        _check_node(src, self.n_pre)
        _check_node(dst, self.n_post)
        e = self._edge_index(src, dst)
        s, d = self.src.cpu().numpy(), self.dst.cpu().numpy()
        ws = self.weights.cpu().numpy()
        dev = self.weights.device
        if w is None:
            if e is None:
                return self
            keep = np.ones(len(ws), bool)
            keep[e] = False
            return SparseGraph.from_arrays(s[keep], d[keep], ws[keep],
                                           self.n_pre, self.n_post, dev)
        if e is not None:
            ws = ws.copy()
            ws[e] = w
            return self.replace_weights(torch.from_numpy(ws).to(dev))
        return SparseGraph.from_arrays(
            np.append(s, src), np.append(d, dst),
            np.append(ws, np.float32(w)), self.n_pre, self.n_post, dev)

    def get_incoming_connections(self, dst):
        _check_node(dst, self.n_post)
        sel = self.dst.cpu().numpy() == dst
        return set(self.src.cpu().numpy()[sel].tolist())

    def get_outgoing_connections(self, src):
        _check_node(src, self.n_pre)
        sel = self.src.cpu().numpy() == src
        return set(self.dst.cpu().numpy()[sel].tolist())

    def apply_edge_update(self, edge_dw, pre_vals, post_vals):
        pre, post = self.edge_pre_post(pre_vals, post_vals)
        return self.replace_weights(
            self.weights + edge_dw(self.weights, pre, post))


# ---------------------------------------------------------------------------
# Stencil graph (translation-local connectivity on a 2-D grid)
# ---------------------------------------------------------------------------


def radius_offsets(radius, include_self=False):
    """All (dr, dc) with Euclidean distance <= radius, row-major."""
    r = int(np.ceil(radius))
    out = []
    for dr in range(-r, r + 1):
        for dc in range(-r, r + 1):
            if not include_self and dr == 0 and dc == 0:
                continue
            if np.sqrt(dr * dr + dc * dc) <= radius:
                out.append((dr, dc))
    return tuple(out)


class StencilGraph:
    """Local connectivity: dst (r, c) receives from src (r + dr, c + dc).

    ``weights``: (n_offsets, rows, cols) f32, per destination and offset;
    ``mask``: the same shape, bool; ``in_deg``: (rows, cols) f32.
    Off-grid offsets are masked (weight 0) at construction.
    """

    def __init__(self, offsets, weights, mask, in_deg=None):
        self.offsets = tuple(tuple(int(x) for x in o) for o in offsets)
        self.weights = weights
        self.mask = mask
        if in_deg is None:
            in_deg = torch.sum(mask.to(torch.float32), dim=0)
        self.in_deg = in_deg

    @property
    def shape(self):
        return tuple(self.weights.shape[1:])

    @property
    def n_pre(self):
        r, c = self.shape
        return r * c

    n_post = n_pre

    @classmethod
    def build(cls, rows, cols, offsets, weight_fn=None, keep_prob=1.0, seed=0,
              device="cpu"):
        """Construct local connectivity on the host and move it to
        ``device``.

        ``weight_fn(dr, dc, rr, cc)`` -> weight array over the destination
        grids rr, cc; default 1.  ``keep_prob`` drops edges i.i.d.: one
        ``rng.random((rows, cols))`` draw per offset, in offset order, only
        when ``keep_prob < 1``.
        """
        offsets = tuple(map(tuple, offsets))
        n_off = len(offsets)
        w = np.zeros((n_off, rows, cols), np.float32)
        m = np.zeros((n_off, rows, cols), bool)
        rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
        rng = np.random.default_rng(seed)
        for o, (dr, dc) in enumerate(offsets):
            sr, sc = rr + dr, cc + dc
            valid = (sr >= 0) & (sr < rows) & (sc >= 0) & (sc < cols)
            if keep_prob < 1.0:
                valid &= rng.random((rows, cols)) <= keep_prob
            if weight_fn is None:
                wo = np.ones((rows, cols), np.float32)
            else:
                wo = np.asarray(weight_fn(dr, dc, rr, cc), np.float32)
            w[o] = np.where(valid, wo, 0.0)
            m[o] = valid
        in_deg = m.sum(axis=0).astype(np.float32)
        return cls(offsets, torch.from_numpy(w).to(device),
                   torch.from_numpy(m).to(device),
                   torch.from_numpy(in_deg).to(device))

    def in_degree(self):
        return self.in_deg.reshape(-1)

    @property
    def _pad(self):
        """Halo width covering every offset."""
        m = 0
        for dr, dc in self.offsets:
            m = max(m, abs(dr), abs(dc))
        return m

    def _padded(self, x):
        """(rows, cols, ...) zero-padded by the halo width on its first two
        axes."""
        p = self._pad
        return F.pad(x, (0, 0) * (x.dim() - 2) + (p, p, p, p))

    def _shifted(self, padded, dr, dc):
        """View of ``padded`` with out[r, c] = x[r + dr, c + dc] (0 off-grid)."""
        p = self._pad
        rows, cols = self.shape
        return padded[p + dr:p + dr + rows, p + dc:p + dc + cols]

    def gather_electrical(self, a_src, sub_v, v_post, g_post):
        """``g * acc / max(in_deg, 1)`` with
        ``acc = sum_o w_o * (a[r+dr, c+dc] - sub[r+dr, c+dc] * v)``, summed
        from 0 in offset order."""
        rows, cols = self.shape
        v = v_post.reshape(rows, cols)
        ap = self._padded(a_src.reshape(rows, cols))
        subp = self._padded(sub_v.reshape(rows, cols))
        acc = torch.zeros((rows, cols), dtype=torch.float32, device=v.device)
        for o, (dr, dc) in enumerate(self.offsets):
            acc = acc + self.weights[o] * (self._shifted(ap, dr, dc)
                                           - self._shifted(subp, dr, dc) * v)
        cnt = torch.clamp(self.in_deg, min=1.0)
        out = g_post.reshape(rows, cols) * acc / cnt
        return out.reshape(-1)

    def gather_chemical(self, t_src, nt_mask_src):
        """Per-type (n, K) neurotransmitter input from the (n, K)
        concentrations and presence mask: ``sums / max(cnts, 1)`` with
        ``sums = sum_o w_o * t[r+dr, c+dc] * m[r+dr, c+dc]`` and ``cnts =
        sum_o mask_o * m[r+dr, c+dc]`` in offset order, and ``cnts > 0``
        as the input's validity."""
        rows, cols = self.shape
        k = t_src.shape[-1]
        tp = self._padded(t_src.reshape(rows, cols, k))
        mp = self._padded(nt_mask_src.reshape(rows, cols, k))
        sums = torch.zeros((rows, cols, k), dtype=torch.float32,
                           device=t_src.device)
        cnts = torch.zeros_like(sums)
        for o, (dr, dc) in enumerate(self.offsets):
            ms = self._shifted(mp, dr, dc)
            sums = sums + self.weights[o][:, :, None] \
                * self._shifted(tp, dr, dc) * ms
            cnts = cnts + self.mask[o][:, :, None] * ms
        t_in = sums / torch.clamp(cnts, min=1.0)
        return t_in.reshape(-1, k), (cnts > 0.0).reshape(-1, k)

    # -- per-edge access --------------------------------------------------------
    def _edge_slot(self, src, dst):
        rows, cols = self.shape
        dr = src // cols - dst // cols
        dc = src % cols - dst % cols
        try:
            o = self.offsets.index((int(dr), int(dc)))
        except ValueError:
            return None
        return (o, dst // cols, dst % cols)

    def lookup_weight(self, src, dst):
        """Weight of the edge src -> dst (flat indices), or None."""
        _check_node(src, self.n_pre)
        _check_node(dst, self.n_post)
        slot = self._edge_slot(src, dst)
        if slot is None or not bool(self.mask[slot]):
            return None
        return float(self.weights[slot])

    def edit_weight(self, src, dst, w):
        """A graph with edge src -> dst set to ``w``, or removed when ``w``
        is None; an edge at a new offset appends a plane."""
        _check_node(src, self.n_pre)
        _check_node(dst, self.n_post)
        rows, cols = self.shape
        slot = self._edge_slot(src, dst)
        weights = self.weights.cpu().numpy()
        mask = self.mask.cpu().numpy()
        offsets = self.offsets
        if slot is None:
            if w is None:
                return self
            offsets = offsets + ((int(src // cols - dst // cols),
                                  int(src % cols - dst % cols)),)
            weights = np.concatenate(
                [weights, np.zeros((1, rows, cols), np.float32)])
            mask = np.concatenate([mask, np.zeros((1, rows, cols), bool)])
            slot = (len(offsets) - 1, dst // cols, dst % cols)
        else:
            weights, mask = weights.copy(), mask.copy()
        if w is None:
            weights[slot] = 0.0
            mask[slot] = False
        else:
            weights[slot] = w
            mask[slot] = True
        dev = self.weights.device
        return StencilGraph(offsets, torch.from_numpy(weights).to(dev),
                            torch.from_numpy(mask).to(dev),
                            torch.from_numpy(mask.sum(axis=0, dtype=np.float32))
                            .to(dev))

    def _connections_of(self, idx, incoming):
        rows, cols = self.shape
        r, c = idx // cols, idx % cols
        mask = self.mask.cpu().numpy()
        out = set()
        for o, (dr, dc) in enumerate(self.offsets):
            if incoming:
                sr, sc = r + dr, c + dc
                if 0 <= sr < rows and 0 <= sc < cols and mask[o, r, c]:
                    out.add(sr * cols + sc)
            else:
                # idx is the source of destination (r - dr, c - dc)
                tr, tc = r - dr, c - dc
                if 0 <= tr < rows and 0 <= tc < cols and mask[o, tr, tc]:
                    out.add(tr * cols + tc)
        return out

    def get_incoming_connections(self, dst):
        """The flat indices of the sources of ``dst``."""
        _check_node(dst, self.n_post)
        return self._connections_of(dst, incoming=True)

    def get_outgoing_connections(self, src):
        """The flat indices of the destinations of ``src``."""
        _check_node(src, self.n_pre)
        return self._connections_of(src, incoming=False)

    # -- per-edge updates (plasticity) ------------------------------------------
    def edge_pre_post(self, pre_vals, post_vals):
        """Views broadcastable to the (n_offsets, rows, cols) weight array:
        ``pre[k][o, r, c] = pre_vals[k][r + dr_o, c + dc_o]`` (0 off-grid,
        where the mask is False), ``post[k]`` is (1, rows, cols)."""
        rows, cols = self.shape
        post = {k: v.reshape(rows, cols)[None] for k, v in post_vals.items()}
        pre = {}
        for k, v in pre_vals.items():
            p = self._padded(v.reshape(rows, cols))
            pre[k] = torch.stack([self._shifted(p, dr, dc)
                                  for dr, dc in self.offsets])
        return pre, post

    @property
    def edge_mask(self):
        return self.mask

    def replace_weights(self, weights):
        return StencilGraph(self.offsets, weights, self.mask, self.in_deg)

    def apply_edge_update(self, edge_dw, pre_vals, post_vals):
        """``w + edge_dw(w, pre, post)`` on every edge the mask holds, in
        one (n_offsets, rows, cols) pass."""
        pre, post = self.edge_pre_post(pre_vals, post_vals)
        dw = edge_dw(self.weights, pre, post)
        return self.replace_weights(
            torch.where(self.mask, self.weights + dw, self.weights))


# ---------------------------------------------------------------------------
# Host builders of `connect(predicate)`
# ---------------------------------------------------------------------------


def positions(rows, cols):
    """All (r, c) grid positions, row-major (the graph's node order)."""
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    return np.stack([rr.reshape(-1), cc.reshape(-1)], axis=-1)


def connect_dense_host(rows, cols, connecting_conditional, weight_logic=None):
    """The (N, N) NumPy weight and mask pair of a pairwise predicate:
    ``mask[i, j]`` is ``connecting_conditional(pos_i, pos_j)`` for pre i
    and post j, each position an (r, c) tuple.  O(N^2) calls."""
    pos = positions(rows, cols)
    n = len(pos)
    mask = np.zeros((n, n), bool)
    w = np.zeros((n, n), np.float32)
    for i in range(n):
        pi = (int(pos[i, 0]), int(pos[i, 1]))
        for j in range(n):
            pj = (int(pos[j, 0]), int(pos[j, 1]))
            if connecting_conditional(pi, pj):
                mask[i, j] = True
                w[i, j] = 1.0 if weight_logic is None else weight_logic(pi, pj)
    return w, mask


def stencil_planes_host(w, mask, rows, cols, max_offsets=128):
    """Per-offset planes of a dense (w, mask) pair: ``(offsets, weight
    planes, mask planes)`` with the offsets in sorted (row-major) order, or
    None when there is no edge or the offset support is too wide."""
    if w.shape != (rows * cols, rows * cols):
        return None
    src, dst = np.nonzero(mask)
    if len(src) == 0:
        return None
    dr = src // cols - dst // cols
    dc = src % cols - dst % cols
    offsets = np.unique(np.stack([dr, dc], axis=1), axis=0)
    if len(offsets) > max_offsets or len(offsets) >= rows * cols // 2:
        return None
    index = {(int(a), int(b)): o for o, (a, b) in enumerate(offsets)}
    n_off = len(offsets)
    wp = np.zeros((n_off, rows, cols), np.float32)
    mp = np.zeros((n_off, rows, cols), bool)
    o_idx = np.array([index[(int(a), int(b))] for a, b in zip(dr, dc)])
    wp[o_idx, dst // cols, dst % cols] = w[src, dst]
    mp[o_idx, dst // cols, dst % cols] = True
    return tuple(map(tuple, offsets)), wp, mp


def connect_dense(rows, cols, connecting_conditional, weight_logic=None,
                  device="cpu"):
    """A pairwise predicate over all position pairs as a `DenseGraph`; the
    predicate and the weight function take ((r1, c1), (r2, c2)).  O(N^2)
    host calls."""
    w, mask = connect_dense_host(rows, cols, connecting_conditional,
                                 weight_logic)
    return DenseGraph(torch.from_numpy(w).to(device),
                      torch.from_numpy(mask).to(device))


def connect_auto(rows, cols, connecting_conditional, weight_logic=None,
                 device="cpu"):
    """`connect(predicate)`: evaluate the predicate on the host, decompose
    it into a `StencilGraph` where the offset support is narrow, keep the
    `DenseGraph` where it is wide or there is no edge, and move the result
    to ``device`` once."""
    w, mask = connect_dense_host(rows, cols, connecting_conditional,
                                 weight_logic)
    st = stencil_planes_host(w, mask, rows, cols)
    if st is None:
        return DenseGraph(torch.from_numpy(w).to(device),
                          torch.from_numpy(mask).to(device))
    offsets, wp, mp = st
    return StencilGraph(offsets, torch.from_numpy(wp).to(device),
                        torch.from_numpy(mp).to(device))


def dense_to_sparse(graph):
    """The edges of a `DenseGraph` as a `SparseGraph` on its device."""
    mask = graph.mask.cpu().numpy()
    w = graph.weights.cpu().numpy()
    src, dst = np.nonzero(mask)
    return SparseGraph.from_arrays(src, dst, w[src, dst], graph.n_pre,
                                   graph.n_post, graph.weights.device)


def dense_to_stencil(graph, rows, cols, max_offsets=128):
    """A square `DenseGraph` whose edge set has narrow offset support as a
    `StencilGraph`, or None when the support is too wide."""
    if graph.n_pre != rows * cols or graph.n_post != rows * cols:
        return None
    st = stencil_planes_host(graph.weights.cpu().numpy(),
                             graph.mask.cpu().numpy(), rows, cols,
                             max_offsets)
    if st is None:
        return None
    offsets, wp, mp = st
    dev = graph.weights.device
    return StencilGraph(offsets, torch.from_numpy(wp).to(dev),
                        torch.from_numpy(mp).to(dev))


def sparse_radius_graph(rows, cols, radius, keep_prob=1.0, seed=0,
                        weight_mode="constant", wparam0=1.0, wparam1=0.0,
                        device="cpu"):
    """Radius-limited lattice connectivity as a `SparseGraph` on
    ``device``, built by the host C++ library (`_native`) where g++ built
    it, else in NumPy: a `StencilGraph.build` of the radius's offsets
    converted to COO.  The two branches draw different edges.
    ``weight_mode`` is constant (``wparam0``), distance, inv_distance or
    gaussian (sigma ``wparam0``, amplitude ``wparam1``) on both; the
    native branch also takes "uniform" (drawn between the two parameters)
    and raises KeyError on "uniform_random", which the NumPy branch draws
    from ``seed + 1`` (treating "uniform" as constant), as the JAX package
    does."""
    from .. import _native
    if _native.available:
        src, dst, w = _native.radius_edges(rows, cols, radius, keep_prob,
                                           seed, weight_mode, wparam0, wparam1)
        return SparseGraph.from_arrays(src, dst, w, rows * cols,
                                       device=device)
    rng = np.random.default_rng(seed + 1)

    def weight_fn(dr, dc, rr, cc):
        dist = float(np.hypot(dr, dc))
        if weight_mode == "distance":
            v = dist * wparam0
        elif weight_mode == "inv_distance":
            v = wparam0 / dist if dist > 0 else wparam0
        elif weight_mode == "gaussian":
            v = wparam1 * np.exp(-dist * dist / (2.0 * wparam0 * wparam0))
        elif weight_mode == "uniform_random":
            return rng.uniform(wparam0, wparam1, rr.shape).astype(np.float32)
        else:
            v = wparam0
        return np.full(rr.shape, v, np.float32)

    g = StencilGraph.build(rows, cols, radius_offsets(radius),
                           weight_fn=weight_fn, keep_prob=keep_prob,
                           seed=seed, device=device)
    return dense_to_sparse_from_stencil(g)


def dense_to_sparse_from_stencil(graph):
    """The edges of a `StencilGraph` as a `SparseGraph` on its device."""
    from ..core.network import _graph_to_coo
    src, dst, w, _ = _graph_to_coo(graph)
    return SparseGraph.from_arrays(src, dst, w, graph.n_pre, graph.n_post,
                                   graph.weights.device)

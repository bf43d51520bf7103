"""`DenseGraph`, the graph converters and the per-edge surface of the
PyTorch port against the JAX package's, on the same NumPy arrays: the host
construction and the per-edge API are exact, the gathers (float32 matrix
products in both packages) agree to rounding.  Also a single `Lattice` on
a `DenseGraph` against the JAX XLA path, and the two gate repairs: wide
stencils take the plain route, and `connect` with no edge gives an empty
`DenseGraph`."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.ops import graph as jg
from spiking_neural_networks_tpu_torch.ops import graph as tg
from spiking_neural_networks_tpu_torch.ops import (network_kernels,
                                                   stencil_kernels)
from spiking_neural_networks_tpu_torch.convert import (graph_from,
                                                       lattice_from)
from spiking_neural_networks_tpu_torch.errors import GraphError

torch.set_num_threads(1)


def dense_pair(n_pre=11, n_post=9, seed=3, p=0.4):
    """The same random (weights, mask) as a JAX and a port `DenseGraph`."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n_pre, n_post)) < p
    w = np.where(mask, rng.normal(0.0, 1.0, (n_pre, n_post)),
                 0.0).astype(np.float32)
    j = jg.DenseGraph(jnp.asarray(w), jnp.asarray(mask))
    return j, graph_from(j, "cpu"), rng


def wide(x, y):
    """A Hopfield-like predicate whose offset support is the whole grid."""
    return x != y and (x[0] * 7 + x[1] * 3 + y[0] * 5 + y[1]) % 3 == 0


def wide_weight(x, y):
    return 0.25 * (x[0] - y[1]) + 0.5


# -- DenseGraph, method by method ------------------------------------------


def test_dense_graph_shape_and_in_degree():
    j, t, _ = dense_pair()
    assert isinstance(t, tg.DenseGraph)
    assert (t.n_pre, t.n_post) == (j.n_pre, j.n_post) == (11, 9)
    assert t.weights.dtype == torch.float32 and t.mask.dtype == torch.bool
    np.testing.assert_array_equal(t.in_degree().numpy(),
                                  np.asarray(j.in_degree()))
    np.testing.assert_array_equal(t.edge_mask.numpy(),
                                  np.asarray(j.edge_mask))
    assert t.has_edges


def test_dense_graph_empty():
    t = tg.DenseGraph.empty(5, 7)
    j = jg.DenseGraph.empty(5, 7)
    assert t.weights.shape == (5, 7) and not t.has_edges
    np.testing.assert_array_equal(t.weights.numpy(), np.asarray(j.weights))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert tg.DenseGraph.empty(4).weights.shape == (4, 4)


def test_has_edges_follows_an_in_place_edit():
    t = tg.DenseGraph.empty(4)
    assert not t.has_edges
    t.mask[1, 2] = True
    assert t.has_edges
    t.mask[1, 2] = False
    assert not t.has_edges


@pytest.mark.parametrize("seed", [1, 2])
def test_dense_gather_electrical_matches_jax(seed):
    """Two float32 matvecs of up to 40 terms: rtol 1e-5, atol 1e-6 times
    the |v| scale of 1e2 (the products sum in the BLAS's order)."""
    j, t, rng = dense_pair(40, 40, seed)
    a = rng.uniform(-65, 30, 40).astype(np.float32)
    sub = (rng.random(40) < 0.7).astype(np.float32)
    v = rng.uniform(-65, 30, 40).astype(np.float32)
    g = rng.uniform(5, 10, 40).astype(np.float32)
    want = np.asarray(j.gather_electrical(*(jnp.asarray(x)
                                            for x in (a, sub, v, g))))
    got = t.gather_electrical(*(torch.from_numpy(x) for x in (a, sub, v, g)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_dense_gather_chemical_matches_jax():
    j, t, rng = dense_pair(30, 20, 5)
    tt = rng.uniform(0, 1, (30, 3)).astype(np.float32)
    m = (rng.random((30, 3)) < 0.7).astype(np.float32)
    want_t, want_v = j.gather_chemical(jnp.asarray(tt), jnp.asarray(m))
    got_t, got_v = t.gather_chemical(torch.from_numpy(tt),
                                     torch.from_numpy(m))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_dense_per_edge_api_matches_jax():
    j, t, _ = dense_pair()
    for src in range(11):
        assert t.get_outgoing_connections(src) == \
            j.get_outgoing_connections(src)
        for dst in range(9):
            assert t.lookup_weight(src, dst) == j.lookup_weight(src, dst)
    for dst in range(9):
        assert t.get_incoming_connections(dst) == \
            j.get_incoming_connections(dst)
    for bad in ((11, 0), (0, 9), (-1, 0)):
        with pytest.raises(GraphError):
            t.lookup_weight(*bad)
    with pytest.raises(GraphError):
        t.get_outgoing_connections(11)


def test_dense_edit_weight_matches_jax():
    j, t, _ = dense_pair()
    src, dst = map(int, np.argwhere(~np.asarray(j.mask))[0])
    esrc, edst = map(int, np.argwhere(np.asarray(j.mask))[0])
    for s, d, w in ((src, dst, 2.5), (esrc, edst, -0.75), (esrc, edst, None),
                    (src, dst, None)):
        j2, t2 = j.edit_weight(s, d, w), t.edit_weight(s, d, w)
        np.testing.assert_array_equal(t2.weights.numpy(),
                                      np.asarray(j2.weights))
        np.testing.assert_array_equal(t2.mask.numpy(), np.asarray(j2.mask))
        assert t2.lookup_weight(s, d) == j2.lookup_weight(s, d)
    # functional: the edited graph is a new one
    assert t.lookup_weight(src, dst) is None


def test_dense_edge_update_matches_jax():
    """`apply_edge_update` and `replace_weights` with an elementwise edge
    function: exact."""
    j, t, rng = dense_pair(8, 8, 9)
    pre = rng.uniform(0, 1, 8).astype(np.float32)
    post = rng.uniform(0, 1, 8).astype(np.float32)

    def dw(w, p, q):
        return 0.5 * p["x"] - 0.25 * q["x"] + 0.0 * w

    j2 = j.apply_edge_update(dw, {"x": jnp.asarray(pre)},
                             {"x": jnp.asarray(post)})
    t2 = t.apply_edge_update(dw, {"x": torch.from_numpy(pre)},
                             {"x": torch.from_numpy(post)})
    np.testing.assert_array_equal(t2.weights.numpy(), np.asarray(j2.weights))
    tp, tq = t.edge_pre_post({"x": torch.from_numpy(pre)},
                             {"x": torch.from_numpy(post)})
    assert tp["x"].shape == (8, 1) and tq["x"].shape == (1, 8)
    t3 = t.replace_weights(t.weights * 2)
    assert t3.mask is t.mask and torch.equal(t3.weights, t.weights * 2)


# -- the rest of SparseGraph and StencilGraph ------------------------------


def test_sparse_from_arrays_and_outgoing_match_jax():
    rng = np.random.default_rng(4)
    n = 9
    src, dst = rng.integers(0, n, 20), rng.integers(0, n, 20)
    w = rng.uniform(0.5, 1.5, 20).astype(np.float32)
    j = jg.SparseGraph.from_arrays(src, dst, w, n)
    t = tg.SparseGraph.from_arrays(src, dst, w, n)
    for a, b in ((t.src, j.src), (t.dst, j.dst), (t.weights, j.weights),
                 (t.in_deg, j.in_deg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for i in range(n):
        assert t.get_outgoing_connections(i) == j.get_outgoing_connections(i)
        assert t.get_incoming_connections(i) == j.get_incoming_connections(i)
    # an edit re-sorts by destination, as the JAX class does
    j2, t2 = j.edit_weight(8, 0, 3.0), t.edit_weight(8, 0, 3.0)
    np.testing.assert_array_equal(t2.src.numpy(), np.asarray(j2.src))
    np.testing.assert_array_equal(t2.weights.numpy(), np.asarray(j2.weights))


def test_stencil_outgoing_matches_jax():
    j = jg.StencilGraph.build(5, 6, jg.radius_offsets(1.5), keep_prob=0.6,
                              seed=9)
    t = tg.StencilGraph.build(5, 6, tg.radius_offsets(1.5), keep_prob=0.6,
                              seed=9)
    for i in range(30):
        assert t.get_outgoing_connections(i) == j.get_outgoing_connections(i)
        assert t.get_incoming_connections(i) == j.get_incoming_connections(i)
    with pytest.raises(GraphError):
        t.get_outgoing_connections(30)


# -- constructors and converters -------------------------------------------


def test_connect_auto_wide_predicate_is_dense():
    j = jg.connect_auto(5, 6, wide, wide_weight)
    t = tg.connect_auto(5, 6, wide, wide_weight)
    assert isinstance(j, jg.DenseGraph) and isinstance(t, tg.DenseGraph)
    np.testing.assert_array_equal(t.weights.numpy(), np.asarray(j.weights))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert not hasattr(tg, "DENSE_NOT_PORTED")


def test_connect_auto_narrow_predicate_stays_stencil():
    def near(x, y):
        return x != y and abs(x[0] - y[0]) + abs(x[1] - y[1]) <= 1
    j = jg.connect_auto(6, 6, near)
    t = tg.connect_auto(6, 6, near)
    assert isinstance(t, tg.StencilGraph) and t.offsets == j.offsets
    np.testing.assert_array_equal(t.weights.numpy(), np.asarray(j.weights))


def test_connect_dense_matches_jax():
    j = jg.connect_dense(4, 5, wide, wide_weight)
    t = tg.connect_dense(4, 5, wide, wide_weight)
    np.testing.assert_array_equal(t.weights.numpy(), np.asarray(j.weights))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))


def assert_sparse_equal(t, j):
    assert (t.n_pre, t.n_post) == (j.n_pre, j.n_post)
    np.testing.assert_array_equal(t.src.numpy(), np.asarray(j.src))
    np.testing.assert_array_equal(t.dst.numpy(), np.asarray(j.dst))
    np.testing.assert_array_equal(t.weights.numpy(), np.asarray(j.weights))
    np.testing.assert_array_equal(t.in_deg.numpy(), np.asarray(j.in_deg))


def test_dense_to_sparse_edge_for_edge():
    j, t, _ = dense_pair()
    assert_sparse_equal(tg.dense_to_sparse(t), jg.dense_to_sparse(j))


def test_dense_to_stencil_edge_for_edge():
    def near(x, y):
        return x != y and max(abs(x[0] - y[0]), abs(x[1] - y[1])) <= 1
    j = jg.connect_dense(6, 7, near, wide_weight)
    t = tg.connect_dense(6, 7, near, wide_weight)
    js, ts = jg.dense_to_stencil(j, 6, 7), tg.dense_to_stencil(t, 6, 7)
    assert ts.offsets == js.offsets
    np.testing.assert_array_equal(ts.weights.numpy(), np.asarray(js.weights))
    np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))
    np.testing.assert_array_equal(ts.in_deg.numpy(), np.asarray(js.in_deg))
    # wide support and a shape that does not fit: None in both
    jw, tw = jg.connect_dense(5, 6, wide), tg.connect_dense(5, 6, wide)
    assert jg.dense_to_stencil(jw, 5, 6) is None
    assert tg.dense_to_stencil(tw, 5, 6) is None
    assert tg.dense_to_stencil(tw, 6, 6) is None


@pytest.mark.parametrize("mode,p0,p1", [
    ("constant", 0.7, 0.0), ("distance", 0.5, 0.0),
    ("inv_distance", 2.0, 0.0), ("gaussian", 1.5, 3.0),
    ("uniform_random", 0.2, 0.9)])
def test_sparse_radius_graph_numpy_branch(mode, p0, p1, monkeypatch):
    """The NumPy branch of the JAX function against the port's (both
    packages' native libraries switched off): the same edges and
    weights."""
    from spiking_neural_networks_tpu import _native
    from spiking_neural_networks_tpu_torch import _native as tnative
    monkeypatch.setattr(_native, "available", False)
    monkeypatch.setattr(tnative, "available", False)
    j = jg.sparse_radius_graph(7, 8, 2.0, keep_prob=0.8, seed=5,
                               weight_mode=mode, wparam0=p0, wparam1=p1)
    t = tg.sparse_radius_graph(7, 8, 2.0, keep_prob=0.8, seed=5,
                               weight_mode=mode, wparam0=p0, wparam1=p1)
    assert_sparse_equal(t, j)
    assert t.src.numel() > 0


def test_dense_to_sparse_from_stencil_edge_for_edge():
    j = jg.StencilGraph.build(6, 5, jg.radius_offsets(2.0), keep_prob=0.7,
                              seed=2)
    t = tg.StencilGraph.build(6, 5, tg.radius_offsets(2.0), keep_prob=0.7,
                              seed=2)
    assert_sparse_equal(tg.dense_to_sparse_from_stencil(t),
                        jg.dense_to_sparse_from_stencil(j))


def test_graph_to_coo_matches_jax_on_every_backend():
    from spiking_neural_networks_tpu.core.network import _graph_to_coo as jcoo
    from spiking_neural_networks_tpu_torch.core.network import \
        _graph_to_coo as tcoo
    jd, td, _ = dense_pair()
    js = jg.StencilGraph.build(4, 5, jg.radius_offsets(1.5), seed=1)
    ts = tg.StencilGraph.build(4, 5, tg.radius_offsets(1.5), seed=1)
    for j, t in ((jd, td), (js, ts), (jg.dense_to_sparse(jd),
                                      tg.dense_to_sparse(td))):
        (a, b, c, pj), (x, y, z, pt) = jcoo(j), tcoo(t)
        np.testing.assert_array_equal(x, a)
        np.testing.assert_array_equal(y, b)
        np.testing.assert_array_equal(z, c)
        assert pt[0] == pj[0]
        if pj[1] is not None:
            np.testing.assert_array_equal(pt[1], pj[1])
    with pytest.raises(TypeError):
        tcoo(object())


def test_graph_from_round_trips_every_class():
    j, t, _ = dense_pair()
    again = graph_from(t, "cpu")          # the port's own attribute names
    assert isinstance(again, tg.DenseGraph)
    assert torch.equal(again.weights, t.weights)
    assert torch.equal(again.mask, t.mask)
    assert isinstance(graph_from(jg.SparseGraph.empty(4), "cpu"),
                      tg.SparseGraph)
    with pytest.raises(TypeError):
        graph_from(object(), "cpu")


# -- the lattice surface ---------------------------------------------------


def lattices(cls_j, cls_t, connect=True):
    j = cls_j(snn.Izhikevich())
    t = cls_t(snt.Izhikevich(), device="cpu")
    for lat in (j, t):
        lat.populate(4, 5, gap_conductance=10.0)
        if connect:
            lat.connect(wide, wide_weight)
    return j, t


@pytest.mark.parametrize("cls_j,cls_t", [
    (snn.Lattice, snt.Lattice),
    (snn.RewardModulatedLattice, snt.RewardModulatedLattice)])
def test_lattice_per_edge_methods_match_jax(cls_j, cls_t):
    j, t = lattices(cls_j, cls_t)
    assert isinstance(t.graph, tg.DenseGraph)
    pts = [(r, c) for r in range(4) for c in range(5)]
    for p in pts:
        assert t.get_incoming_connections(p) == j.get_incoming_connections(p)
        assert t.get_outgoing_connections(p) == j.get_outgoing_connections(p)
        for q in pts[::3]:
            assert t.lookup_weight(p, q) == j.lookup_weight(p, q)
    for lat in (j, t):
        lat.edit_weight((0, 0), (0, 0), 1.25)
        lat.edit_weight((1, 1), (0, 2), None)
    assert t.lookup_weight((0, 0), (0, 0)) == 1.25
    np.testing.assert_array_equal(t.graph.weights.numpy(),
                                  np.asarray(j.graph.weights))
    np.testing.assert_array_equal(t.graph.mask.numpy(),
                                  np.asarray(j.graph.mask))
    with pytest.raises(GraphError):
        t.lookup_weight((4, 0), (0, 0))
    with pytest.raises(GraphError):
        t._flat((0, 5))


@pytest.mark.parametrize("kind", ["stencil", "sparse"])
def test_reward_edit_weight_carries_traces(kind):
    """A new stencil offset zero-pads the traces; a sparse graph remaps
    them by (src, dst) pair: as the JAX class does."""
    j, t = lattices(snn.RewardModulatedLattice, snt.RewardModulatedLattice,
                    connect=False)
    rng = np.random.default_rng(2)
    for lat, mod in ((j, jg), (t, tg)):
        if kind == "stencil":
            lat.connect_stencil(radius=1.0)
        else:
            lat.graph = mod.dense_to_sparse_from_stencil(
                mod.StencilGraph.build(4, 5, mod.radius_offsets(1.0)))
            lat._reset_trace()
    shp = tuple(t.graph.weights.shape)
    c = rng.uniform(-1, 1, shp).astype(np.float32)
    j.trace = {**j.trace, "c": jnp.asarray(c)}
    t.trace = {**t.trace, "c": torch.from_numpy(c)}
    for lat in (j, t):
        lat.edit_weight((3, 4), (0, 0), 0.5)      # a new offset / edge
        lat.edit_weight((0, 1), (0, 0), None)     # an existing edge
    for k in ("c", "dw", "counter"):
        np.testing.assert_array_equal(t.trace[k].numpy(),
                                      np.asarray(j.trace[k]), err_msg=k)
    assert t.trace["c"].shape == t.graph.weights.shape
    assert t.lookup_weight((3, 4), (0, 0)) == 0.5
    assert t.lookup_weight((0, 1), (0, 0)) is None


def test_falliable_connect_and_update():
    j, t = lattices(snn.Lattice, snt.Lattice, connect=False)
    for lat in (j, t):
        lat.falliable_connect(wide, wide_weight)
    np.testing.assert_array_equal(t.graph.weights.numpy(),
                                  np.asarray(j.graph.weights))

    def failing(x, y):
        raise ValueError("no")
    with pytest.raises(ValueError):
        t.falliable_connect(failing)
    v0 = np.random.default_rng(1).uniform(-65, 30, 20).astype(np.float32)
    j.apply(lambda s: {**s, "v": jnp.asarray(v0)})
    t.apply(lambda s: {**s, "v": torch.from_numpy(v0)})
    j.use_pallas = False
    for lat in (j, t):
        lat.update()
    assert t.internal_clock == j.internal_clock == 1
    np.testing.assert_allclose(t.state["v"].numpy(), np.asarray(j.state["v"]),
                               rtol=1e-5, atol=1e-5)


# -- a single lattice on a DenseGraph --------------------------------------


def dense_lattice(use_kernel=None):
    """A 7x7 Izhikevich lattice with Hopfield-dense weights (the Bayesian
    network's excitatory graph), built in JAX and carried over."""
    rng = np.random.default_rng(5)
    w = rng.normal(0.0, 1.0, (49, 49))
    w[np.abs(w) < 0.8] = 0.0
    np.fill_diagonal(w, 0.0)
    j = snn.Lattice(snn.Izhikevich())
    j.populate(7, 7, gap_conductance=10.0)
    j.connect(lambda x, y: bool(w[x[0] * 7 + x[1]][y[0] * 7 + y[1]] != 0),
              lambda x, y: float(w[x[0] * 7 + x[1]][y[0] * 7 + y[1]]))
    j.apply(lambda s: {**s, "v": jnp.asarray(
        rng.uniform(-65, 30, 49), jnp.float32)})
    j.use_pallas = False
    t = lattice_from(j, device="cpu")
    t.use_kernel = use_kernel
    return j, t


def test_dense_lattice_one_step_matches_jax():
    j, t = dense_lattice()
    assert isinstance(t.graph, tg.DenseGraph)
    j.run_lattice(1)
    t.run_lattice(1)
    assert t._last_run_fused is False
    np.testing.assert_allclose(t.state["v"].numpy(), np.asarray(j.state["v"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t.state["last_firing_time"].numpy(),
                                  np.asarray(j.state["last_firing_time"]))


@pytest.mark.parametrize("use_kernel", [None, True])
def test_dense_lattice_200_steps_within_reference_criterion(use_kernel):
    """200 steps with a grid history: within the reference's CPU-vs-GPU
    criterion (2 mV, 2 steps); no kernel gate accepts a `DenseGraph`."""
    j, t = dense_lattice(use_kernel)
    for lat in (j, t):
        lat.update_grid_history = True
        lat.run_lattice(200)
    assert t._last_run_fused is False
    hj = np.stack([np.asarray(x) for x in j.grid_history.history])
    ht = np.stack(t.grid_history.history)
    assert ht.shape == hj.shape == (200, 7, 7)
    assert np.abs(ht - hj).max() <= 2.0
    lj = np.asarray(j.state["last_firing_time"]).astype(np.int64)
    lt = t.state["last_firing_time"].numpy().astype(np.int64)
    assert (lj >= 0).any() and np.abs(lt - lj).max() <= 2


def test_dense_reward_lattice_plain_route_matches_jax():
    j, t = lattices(snn.RewardModulatedLattice, snt.RewardModulatedLattice)
    v0 = np.random.default_rng(3).uniform(-65, 30, 20).astype(np.float32)
    j.apply(lambda s: {**s, "v": jnp.asarray(v0)})
    t.apply(lambda s: {**s, "v": torch.from_numpy(v0)})
    j.use_pallas = False
    t.use_kernel = True
    for lat in (j, t):
        lat.run_lattice_with_reward(0.005, 20)
    assert t._last_run_fused is False
    np.testing.assert_allclose(t.state["v"].numpy(), np.asarray(j.state["v"]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(t.graph.weights.numpy(),
                               np.asarray(j.graph.weights), rtol=1e-5,
                               atol=1e-5)


# -- the two repairs -------------------------------------------------------


def wide_stencil_lattices(how):
    """A 16x16 Izhikevich lattice on a stencil of more than 64 offsets: 80
    from ``connect_stencil(radius=5)``, 112 from a `connect` predicate."""
    rng = np.random.default_rng(8)
    v0 = rng.uniform(-65, 45, 256).astype(np.float32)   # some fire at once
    j = snn.Lattice(snn.Izhikevich())
    j.populate(16, 16, gap_conductance=10.0)
    if how == "radius":
        j.connect_stencil(radius=5, keep_prob=0.8, seed=4)
    else:
        j.connect(lambda x, y: x != y and abs(x[0] - y[0]) <= 5
                  and abs(x[1] - y[1]) <= 5
                  and (x[0] - y[0] + x[1] - y[1]) % 16 != 3)
    j.apply(lambda s: {**s, "v": jnp.asarray(v0)})
    j.use_pallas = False
    return j


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("how", ["radius", "predicate"])
def test_wide_stencil_takes_the_plain_route(how, use_kernel):
    """More than 64 offsets: the stencil gate refuses, the run takes the
    plain route, says so and matches the JAX XLA path; it does not
    raise."""
    j = wide_stencil_lattices(how)
    t = lattice_from(j, device="cpu")
    assert isinstance(t.graph, tg.StencilGraph)
    assert 64 < len(t.graph.offsets) <= 128
    assert not stencil_kernels.supports(t.model, t.graph, True, False, False)
    t.use_kernel = use_kernel
    j.run_lattice(20)
    t.run_lattice(20)
    assert t._last_run_fused is False
    np.testing.assert_allclose(t.state["v"].numpy(), np.asarray(j.state["v"]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(t.state["last_firing_time"].numpy(),
                                  np.asarray(j.state["last_firing_time"]))
    assert (t.state["last_firing_time"] >= 0).any()


def test_stencil_gate_accepts_64_offsets():
    offsets = tg.radius_offsets(4.5)[:64]
    g = tg.StencilGraph.build(12, 12, offsets)
    assert len(g.offsets) == 64
    assert stencil_kernels.supports(snt.Izhikevich(), g, True, False, False)


def test_connect_with_no_edge_is_an_empty_dense_graph():
    """As the JAX `connect_auto`: an empty `DenseGraph`, which `convert`
    round-trips and the network gate counts as edgeless ("none"), where
    the JAX gate counts it as dense."""
    j, t = lattices(snn.Lattice, snt.Lattice, connect=False)
    for lat in (j, t):
        lat.connect(lambda x, y: False)
    assert isinstance(j.graph, jg.DenseGraph)
    assert isinstance(t.graph, tg.DenseGraph) and not t.graph.has_edges
    assert t.graph.weights.shape == (20, 20)
    assert isinstance(lattice_from(j, device="cpu").graph, tg.DenseGraph)
    assert network_kernels._graph_kind(t) == "none"
    t.connect(wide)
    assert network_kernels._graph_kind(t) == "dense"
    v0 = np.random.default_rng(1).uniform(-65, 30, 20).astype(np.float32)
    for lat, arr in ((j, jnp.asarray(v0)), (t, torch.from_numpy(v0))):
        lat.connect(lambda x, y: False)
        lat.apply(lambda s, arr=arr: {**s, "v": arr})
    j.use_pallas = False
    j.run_lattice(30)
    t.run_lattice(30)
    np.testing.assert_allclose(t.state["v"].numpy(), np.asarray(j.state["v"]),
                               rtol=1e-5, atol=1e-4)

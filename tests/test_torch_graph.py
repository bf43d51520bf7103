"""Graphs of the PyTorch package against the JAX package's: the host
construction is array-equal, the gathers agree to rounding."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spiking_neural_networks_tpu.ops import graph as jg
from spiking_neural_networks_tpu_torch.ops import graph as tg
from spiking_neural_networks_tpu_torch.convert import stencil_graph_from_numpy
from spiking_neural_networks_tpu_torch.errors import GraphError

torch.set_num_threads(1)


@pytest.mark.parametrize("radius", [1.0, 1.5, 2.0, 3.0])
def test_radius_offsets_equal(radius):
    assert tg.radius_offsets(radius) == jg.radius_offsets(radius)
    assert tg.radius_offsets(radius, include_self=True) == \
        jg.radius_offsets(radius, include_self=True)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("keep_prob", [1.0, 0.8])
def test_stencil_build_array_equal(seed, keep_prob):
    """Same `default_rng(seed)` draws in the same order: identical arrays."""
    rows, cols = 12, 9
    offsets = jg.radius_offsets(2.0)
    j = jg.StencilGraph.build(rows, cols, offsets, keep_prob=keep_prob,
                              seed=seed)
    t = tg.StencilGraph.build(rows, cols, offsets, keep_prob=keep_prob,
                              seed=seed)
    assert t.offsets == j.offsets and t.shape == tuple(j.shape)
    np.testing.assert_array_equal(t.weights.numpy(), np.asarray(j.weights))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(t.in_deg.numpy(), np.asarray(j.in_deg))
    assert t.weights.dtype == torch.float32 and t.mask.dtype == torch.bool


def test_stencil_build_weight_fn_array_equal():
    def weight_fn(dr, dc, rr, cc):
        return 0.5 + 0.1 * dr - 0.05 * dc + 0.01 * rr * cc

    offsets = jg.radius_offsets(1.5)
    j = jg.StencilGraph.build(7, 10, offsets, weight_fn=weight_fn,
                              keep_prob=0.7, seed=3)
    t = tg.StencilGraph.build(7, 10, offsets, weight_fn=weight_fn,
                              keep_prob=0.7, seed=3)
    np.testing.assert_array_equal(t.weights.numpy(), np.asarray(j.weights))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))


def test_stencil_gather_electrical_matches_jax():
    """One gather.  Both sum sum_o w_o (a - sub v) and then g acc / cnt, but
    XLA picks the order of the offset sum at this size (a stacked-plane
    reduction), so the two agree to f32 rounding of a 12-term sum:
    rtol 1e-6, atol 1e-5 (the JAX package's own fused-vs-XLA tolerance)."""
    rows, cols = 10, 13
    rng = np.random.default_rng(5)
    j = jg.StencilGraph.build(rows, cols, jg.radius_offsets(2.0),
                              weight_fn=lambda dr, dc, rr, cc:
                              rng.uniform(0.5, 1.5, rr.shape),
                              keep_prob=0.8, seed=2)
    t = stencil_graph_from_numpy(j.offsets, np.asarray(j.weights),
                                 np.asarray(j.mask), np.asarray(j.in_deg),
                                 "cpu")
    n = rows * cols
    a = rng.uniform(-65, 30, n).astype(np.float32)
    sub = (rng.random(n) < 0.7).astype(np.float32)
    v = rng.uniform(-65, 30, n).astype(np.float32)
    g = rng.uniform(5, 10, n).astype(np.float32)
    want = np.asarray(j.gather_electrical(jnp.asarray(a), jnp.asarray(sub),
                                          jnp.asarray(v), jnp.asarray(g)))
    got = t.gather_electrical(*(torch.from_numpy(x) for x in (a, sub, v, g)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_sparse_empty_gather_is_zero():
    n = 6
    t = tg.SparseGraph.empty(n)
    j = jg.SparseGraph.empty(n)
    v = np.random.default_rng(1).uniform(-65, 30, n).astype(np.float32)
    g = np.full(n, 10.0, np.float32)
    got = t.gather_electrical(torch.from_numpy(v), torch.ones(n),
                              torch.from_numpy(v), torch.from_numpy(g))
    want = np.asarray(j.gather_electrical(jnp.asarray(v), jnp.ones(n),
                                          jnp.asarray(v), jnp.asarray(g)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.any()
    np.testing.assert_array_equal(t.in_degree().numpy(), np.zeros(n))


def test_sparse_gather_electrical_matches_jax():
    """A small COO graph: index_add_ against segment_sum (sums of at most a
    few terms per destination: rtol 1e-6, atol 1e-5)."""
    rng = np.random.default_rng(4)
    n = 9
    src = rng.integers(0, n, 20)
    dst = rng.integers(0, n, 20)
    w = rng.uniform(0.5, 1.5, 20).astype(np.float32)
    j = jg.SparseGraph.from_arrays(src, dst, w, n)
    t = tg.SparseGraph(torch.from_numpy(np.asarray(j.src, np.int64)),
                       torch.from_numpy(np.asarray(j.dst, np.int64)),
                       torch.from_numpy(np.array(j.weights)), n, n)
    np.testing.assert_array_equal(t.in_degree().numpy(),
                                  np.asarray(j.in_degree()))
    v = rng.uniform(-65, 30, n).astype(np.float32)
    g = rng.uniform(5, 10, n).astype(np.float32)
    got = t.gather_electrical(torch.from_numpy(v), torch.ones(n),
                              torch.from_numpy(v), torch.from_numpy(g))
    want = np.asarray(j.gather_electrical(jnp.asarray(v), jnp.ones(n),
                                          jnp.asarray(v), jnp.asarray(g)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_stencil_lookup_weight_matches_jax():
    j = jg.StencilGraph.build(5, 6, jg.radius_offsets(1.5), keep_prob=0.6,
                              seed=9)
    t = tg.StencilGraph.build(5, 6, tg.radius_offsets(1.5), keep_prob=0.6,
                              seed=9)
    for src in range(30):
        for dst in range(30):
            assert t.lookup_weight(src, dst) == j.lookup_weight(src, dst)
    with pytest.raises(GraphError):
        t.lookup_weight(0, 30)

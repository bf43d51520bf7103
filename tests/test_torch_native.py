"""The port's host graph builder (`spiking_neural_networks_tpu_torch.
_native`) against the JAX package's: the cases of ``tests/test_native.py``
through the port, every entry bit-equal to the JAX library's on the same
arguments, and `ops.graph.sparse_radius_graph` edge for edge with the
native branch on in both packages (the repair: the port took the NumPy
branch, which draws other edges).  Exact: no tolerance."""

import os

import numpy as np
import pytest
import torch

from spiking_neural_networks_tpu import _native as jn
from spiking_neural_networks_tpu.ops import graph as jg
from spiking_neural_networks_tpu_torch import _native as tn
from spiking_neural_networks_tpu_torch.ops import graph as tg

torch.set_num_threads(1)

# the modes each branch accepts: the library's names
NATIVE_MODES = [("constant", 0.7, 0.0), ("distance", 0.5, 0.0),
                ("inv_distance", 2.0, 0.0), ("gaussian", 1.5, 3.0),
                ("uniform", 0.2, 0.9)]


def test_native_available():
    assert tn.available, "g++ toolchain should build graphlib"
    path = tn.library_path()
    assert os.path.exists(path)
    assert os.path.join("spiking_neural_networks_tpu_torch", "_build",
                        "native") in path


def test_radius_edges_match_stencil_structure():
    rows = cols = 16
    src, dst, w = tn.radius_edges(rows, cols, radius=2.0)
    edges = set()
    for r in range(rows):
        for c in range(cols):
            for dr in range(-2, 3):
                for dc in range(-2, 3):
                    if (dr, dc) == (0, 0) or dr * dr + dc * dc > 4:
                        continue
                    sr, sc = r + dr, c + dc
                    if 0 <= sr < rows and 0 <= sc < cols:
                        edges.add((sr * cols + sc, r * cols + c))
    assert set(zip(src.tolist(), dst.tolist())) == edges
    assert (w == 1.0).all()


def test_radius_edges_keep_prob_and_weights():
    kw = dict(keep_prob=0.5, seed=9, weight_mode="uniform", wparam0=0.5,
              wparam1=1.5)
    src, dst, w = tn.radius_edges(32, 32, 2.0, **kw)
    full, _, _ = tn.radius_edges(32, 32, 2.0)
    assert 0.4 < len(src) / len(full) < 0.6
    assert (w >= 0.5).all() and (w < 1.5).all()
    src2, dst2, w2 = tn.radius_edges(32, 32, 2.0, **kw)
    np.testing.assert_array_equal(src, src2)
    np.testing.assert_array_equal(w, w2)


def test_random_edges():
    src, dst, w = tn.random_edges(100, 100, 0.3, seed=2)
    assert 0.25 < len(src) / (100 * 99) < 0.35
    assert not (src == dst).any()


def test_hopfield_weights_match_python():
    rng = np.random.default_rng(3)
    patterns = (rng.random((3, 25)) < 0.5).astype(np.uint8)
    got = tn.hopfield_weights(patterns, a=0.5, b=0.5, scalar=2.0)
    want = np.zeros((25, 25))
    for p in patterns.astype(np.float64):
        want += np.outer(p - 0.5, p - 0.5)
    np.fill_diagonal(want, 0.0)
    np.testing.assert_allclose(got, want * 2.0, rtol=1e-6)


def test_in_degree():
    deg = tn.in_degree(np.array([0, 0, 1, 3, 3, 3], np.int32), 5)
    np.testing.assert_array_equal(deg, [2, 1, 0, 3, 0])


def assert_triples_equal(t, j):
    for a, b in zip(t, j):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode,p0,p1", NATIVE_MODES)
def test_radius_edges_bit_equal(mode, p0, p1):
    for args in ((7, 8, 2.0, 0.8, 5), (13, 9, 3.0, 1.0, 1),
                 (20, 20, 1.5, 0.3, 11)):
        assert_triples_equal(tn.radius_edges(*args, mode, p0, p1),
                             jn.radius_edges(*args, mode, p0, p1))


@pytest.mark.parametrize("exclude_self", [True, False])
def test_random_edges_bit_equal(exclude_self):
    for mode, p0, p1 in (("constant", 0.5, 0.0), ("uniform", -1.0, 2.0)):
        assert_triples_equal(
            tn.random_edges(40, 30, 0.2, exclude_self, 4, mode, p0, p1),
            jn.random_edges(40, 30, 0.2, exclude_self, 4, mode, p0, p1))


def test_hopfield_and_in_degree_bit_equal():
    rng = np.random.default_rng(8)
    patterns = (rng.random((4, 36)) < 0.4).astype(np.uint8)
    for a, b, s in ((0.0, 0.0, 1.0), (0.5, 0.3, 2.5)):
        np.testing.assert_array_equal(tn.hopfield_weights(patterns, a, b, s),
                                      jn.hopfield_weights(patterns, a, b, s))
    dst = rng.integers(0, 50, 400).astype(np.int32)
    np.testing.assert_array_equal(tn.in_degree(dst, 50),
                                  jn.in_degree(dst, 50))


def assert_sparse_equal(t, j):
    assert (t.n_pre, t.n_post) == (j.n_pre, j.n_post)
    np.testing.assert_array_equal(t.src.numpy(), np.asarray(j.src))
    np.testing.assert_array_equal(t.dst.numpy(), np.asarray(j.dst))
    np.testing.assert_array_equal(t.weights.numpy(), np.asarray(j.weights))
    np.testing.assert_array_equal(t.in_deg.numpy(), np.asarray(j.in_deg))


def test_sparse_radius_graph_repair():
    """The case that showed the fault: 425 edges in both packages."""
    assert jn.available and tn.available
    j = jg.sparse_radius_graph(7, 8, 2.0, keep_prob=0.8, seed=5)
    t = tg.sparse_radius_graph(7, 8, 2.0, keep_prob=0.8, seed=5)
    assert_sparse_equal(t, j)
    assert t.src.numel() == 425
    assert t.weights.device == torch.device("cpu")


@pytest.mark.parametrize("mode,p0,p1", NATIVE_MODES)
def test_sparse_radius_graph_native_edge_for_edge(mode, p0, p1):
    kw = dict(keep_prob=0.8, seed=5, weight_mode=mode, wparam0=p0,
              wparam1=p1)
    assert_sparse_equal(tg.sparse_radius_graph(9, 11, 2.5, **kw),
                        jg.sparse_radius_graph(9, 11, 2.5, **kw))


def test_sparse_radius_graph_uniform_random_key_error():
    """With the library built, "uniform_random" (the NumPy branch's name)
    is not a library mode: both packages raise KeyError."""
    kw = dict(keep_prob=0.8, seed=5, weight_mode="uniform_random",
              wparam0=0.2, wparam1=0.9)
    with pytest.raises(KeyError):
        jg.sparse_radius_graph(7, 8, 2.0, **kw)
    with pytest.raises(KeyError):
        tg.sparse_radius_graph(7, 8, 2.0, **kw)


def test_unavailable_raises(monkeypatch):
    monkeypatch.setattr(tn, "available", False)
    with pytest.raises(RuntimeError, match="unavailable"):
        tn.radius_edges(4, 4, 1.0)

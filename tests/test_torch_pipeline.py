"""The port's pipelines (`parallel.pipeline`): a chain of lattices, one
stage per position of a virtual CPU mesh, against the port's own
structured runner (`run_lattices`, `run_lattices_with_reward`) and, where
the JAX package's test is not marked slow, against its `run_pipelined` on
its virtual devices.  The chains are tests/test_pipeline.py's, built in the
JAX package and carried into the port by `convert`.  Tolerance: rtol
2e-5 / atol 2e-4 on v (2e-4 on weights and traces) with more than 99% of
the neurons agreeing on whether they fired (tests/test_pipeline.py's)."""

import numpy as np
import jax
import pytest
import torch

import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.parallel import run_pipelined as jax_pipelined
from spiking_neural_networks_tpu_torch.convert import (network_from,
                                                       reward_network_from)
from spiking_neural_networks_tpu_torch.errors import LatticeNetworkError
from spiking_neural_networks_tpu_torch.parallel import (
    make_pipeline_mesh, run_pipelined, run_pipelined_with_reward)
from test_pipeline import _chain, _mesh, _reward_chain

torch.set_num_threads(1)
CPU = torch.device("cpu")


def mesh(stages):
    return make_pipeline_mesh(stages, devices=[CPU] * stages)


def ports(jnet, reward=False):
    """Two port copies of JAX network ``jnet``."""
    conv = reward_network_from if reward else network_from
    return conv(jnet, device="cpu"), conv(jnet, device="cpu")


def lattice(net, k):
    return net.reward_modulated_lattices.get(k) or net.lattices[k] \
        if hasattr(net, "reward_modulated_lattices") else net.lattices[k]


def assert_chain_close(a, b, stages, weights=False):
    """Chain ``b`` against chain ``a`` (either package): v within rtol 2e-5
    / atol 2e-4, firing agreement above 99%, and with ``weights`` the
    intra weights within 2e-4; returns the neurons that fired in ``a``."""
    fired = 0
    for k in range(stages):
        la, lb = lattice(a, k), lattice(b, k)
        va, vb = (np.asarray(x.state["v"]) for x in (la, lb))
        np.testing.assert_allclose(vb, va, rtol=2e-5, atol=2e-4,
                                   err_msg=f"v {k}")
        fa, fb = (np.asarray(x.state["last_firing_time"]) for x in (la, lb))
        assert ((fa >= 0) == (fb >= 0)).mean() > 0.99
        fired += int((fa >= 0).sum())
        if weights:
            np.testing.assert_allclose(np.asarray(lb.graph.weights),
                                       np.asarray(la.graph.weights),
                                       rtol=2e-4, atol=2e-4,
                                       err_msg=f"weights {k}")
    return fired


@pytest.fixture(scope="module")
def jax_devices():
    if jax.device_count() < 4:
        pytest.skip("needs 4 virtual devices")


def test_pipeline_matches_structured_electrical(jax_devices):
    j = _chain(stages=4, seed=3)
    a, b = ports(j)
    a.run_lattices(200)
    b.run_lattices_pipelined(200, mesh=mesh(4))
    assert assert_chain_close(a, b, 4) > 0
    jax_pipelined(j, 200, mesh=_mesh(4))
    assert_chain_close(j, b, 4)
    for key in a.connections:
        np.testing.assert_array_equal(a.connections[key][2],
                                      b.connections[key][2])


def test_pipeline_plasticity_matches_structured():
    j = _chain(stages=3, plastic=(0, 2), seed=5, stagger=True)
    a, b = ports(j)
    w0 = [lattice(a, k).graph.weights.clone() for k in range(3)]
    a.run_lattices(150)
    run_pipelined(b, 150, mesh=mesh(3))
    assert_chain_close(a, b, 3, weights=True)
    for k in (0, 2):
        assert not torch.equal(lattice(b, k).graph.weights, w0[k])
    assert torch.equal(lattice(b, 1).graph.weights, w0[1])
    for key in ((0, 1), (1, 2)):
        np.testing.assert_allclose(b.connections[key][2],
                                   a.connections[key][2], rtol=2e-4,
                                   atol=2e-4)


def test_pipeline_chemical_chain():
    j = _chain(stages=2, chemical=True, seed=7)
    a, b = ports(j)
    a.run_lattices(100)
    run_pipelined(b, 100, mesh=mesh(2))
    assert assert_chain_close(a, b, 2) > 0
    for k in range(2):
        np.testing.assert_allclose(lattice(b, k).state["nt$t"].numpy(),
                                   lattice(a, k).state["nt$t"].numpy(),
                                   rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("chunk", [None, 16])
def test_pipeline_grid_history(chunk, jax_devices):
    """Grid histories through the pipeline equal the structured runner's
    and the JAX pipeline's; chunked at 16 steps they equal the unchunked
    run."""
    j = _chain(stages=2, seed=13 if chunk else 9, history=True)
    a, b = ports(j)
    b.history_chunk = chunk
    a.run_lattices(50)
    run_pipelined(b, 50, mesh=mesh(2))
    assert b.internal_clock == 50
    jax_pipelined(j, 50, mesh=_mesh(2))
    for k in range(2):
        ha = np.stack(lattice(a, k).grid_history.history)
        hb = np.stack(lattice(b, k).grid_history.history)
        hj = np.stack([np.asarray(x) for x in
                       lattice(j, k).grid_history.history])
        assert ha.shape == hb.shape == hj.shape == (50, 8, 8)
        np.testing.assert_allclose(hb, ha, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(hb, hj, rtol=2e-5, atol=2e-4)


def test_pipeline_rejects_non_chain():
    a, _ = ports(_chain(stages=3, seed=1))
    a.connect(2, 0, lambda p, q: p == q, lambda p, q: 1.0)
    with pytest.raises(LatticeNetworkError, match="not a chain"):
        run_pipelined(a, 10, mesh=mesh(3))


def test_pipeline_clock_and_repeat_runs(jax_devices):
    j = _chain(stages=2, seed=11)
    a, b = ports(j)
    m = mesh(2)
    run_pipelined(b, 60, mesh=m)
    run_pipelined(b, 60, mesh=m)
    assert b.internal_clock == 120
    assert lattice(b, 0).internal_clock == 120
    a.run_lattices(120)
    assert_chain_close(a, b, 2)
    for _ in range(2):
        jax_pipelined(j, 60, mesh=_mesh(2))
    assert_chain_close(j, b, 2)


def test_pipeline_rejects_reward_networks():
    rnet = snt.RewardModulatedLatticeNetwork()
    for k in range(2):
        lat = snt.Lattice(snt.Izhikevich(), id=k, device="cpu")
        lat.populate(4, 4, gap_conductance=10.0)
        lat.connect_stencil(radius=1.0, seed=k)
        rnet.add_lattice(lat)
    rnet.connect_with_reward_modulation(0, 1, lambda p, q: p == q,
                                        lambda p, q: 1.0)
    with pytest.raises(LatticeNetworkError, match="reward"):
        rnet.run_lattices_pipelined(10, mesh=mesh(2))


def test_pipeline_validation_errors():
    """The chain checks raise `LatticeNetworkError`: a link that is not
    one-to-one, stencils of different offsets, a COO intra graph, a mesh
    of another size, a spike-train lattice; a mesh past the devices
    raises ValueError."""
    a, _ = ports(_chain(stages=2, seed=1))
    a.connect(0, 1, lambda p, q: p == (q[0], (q[1] + 1) % 8))
    with pytest.raises(LatticeNetworkError, match="one-to-one"):
        run_pipelined(a, 5, mesh=mesh(2))
    a, _ = ports(_chain(stages=2, seed=1))
    a.lattices[1].connect_stencil(radius=2.0)
    with pytest.raises(LatticeNetworkError, match="offset"):
        run_pipelined(a, 5, mesh=mesh(2))
    a, _ = ports(_chain(stages=2, seed=1))
    for lat in a.lattices.values():
        lat.graph = snt.SparseGraph.empty(64)
    with pytest.raises(LatticeNetworkError, match="StencilGraph"):
        run_pipelined(a, 5, mesh=mesh(2))
    a, _ = ports(_chain(stages=2, seed=1))
    with pytest.raises(LatticeNetworkError, match="devices for"):
        run_pipelined(a, 5, mesh=mesh(3))
    a, _ = ports(_chain(stages=2, seed=1))
    st = snt.SpikeTrainLattice(snt.RateSpikeTrain(), id=9, device="cpu")
    st.populate(8, 8, rate=2.0)
    a.add_spike_train_lattice(st)
    with pytest.raises(LatticeNetworkError, match="spike-train"):
        run_pipelined(a, 5, mesh=mesh(2))
    with pytest.raises(ValueError):
        make_pipeline_mesh(3, devices=[CPU] * 2)


REWARD_CASES = {
    "reward": (dict(stages=4, seed=11), 0.4, 120),
    "mixed": (dict(stages=4, seed=13, mixed=True), 0.5, 100),
}


@pytest.mark.parametrize("case", sorted(REWARD_CASES))
def test_reward_pipeline_matches_structured(case):
    kw, reward, steps = REWARD_CASES[case]
    j = _reward_chain(**kw)
    a, b = ports(j, reward=True)
    w0 = lattice(a, 0).graph.weights.clone()
    a.run_lattices_with_reward(reward, steps)
    b.run_lattices_with_reward_pipelined(reward, steps,
                                         mesh=mesh(kw["stages"]))
    assert abs(a.dopamine - b.dopamine) < 1e-5 * a.dopamine
    assert assert_chain_close(a, b, kw["stages"], weights=True) > 0
    assert not torch.equal(lattice(b, 0).graph.weights, w0)
    for k in range(kw["stages"]):
        la, lb = lattice(a, k), lattice(b, k)
        if getattr(la, "trace", None) is not None:
            for f in ("c", "dw", "counter"):
                np.testing.assert_allclose(lb.trace[f].numpy(),
                                           la.trace[f].numpy(), rtol=2e-4,
                                           atol=2e-4, err_msg=f"{f} {k}")
            assert lb.dopamine == b.dopamine
        assert torch.equal(la.state["last_firing_time"],
                           lb.state["last_firing_time"])
    for link, conn in a.connections.items():
        np.testing.assert_allclose(b.connections[link][2], conn[2],
                                   rtol=2e-4, atol=2e-4)
    for link, conn in a.reward_connections.items():
        for fa, fb in zip(conn[2:], b.reward_connections[link][2:]):
            np.testing.assert_allclose(fb, fa, rtol=2e-4, atol=2e-4)


def test_reward_pipeline_grid_history():
    j = _reward_chain(stages=3, seed=17, history=True)
    a, b = ports(j, reward=True)
    a.run_lattices_with_reward(0.3, 60)
    run_pipelined_with_reward(b, 0.3, 60, mesh=mesh(3))
    for k in range(3):
        ha = np.stack(lattice(a, k).grid_history.history)
        hb = np.stack(lattice(b, k).grid_history.history)
        assert ha.shape == hb.shape == (60, 6, 6)
        np.testing.assert_allclose(hb, ha, rtol=2e-5, atol=2e-4)


def test_reward_pipeline_zero_iterations():
    net, _ = ports(_reward_chain(stages=2, history=True), reward=True)
    run_pipelined_with_reward(net, 0.4, 0, mesh=mesh(2))
    assert net.internal_clock == 0
    plain, _ = ports(_chain(stages=2, history=True))
    run_pipelined(plain, 0, mesh=mesh(2))
    assert plain.internal_clock == 0
    assert not lattice(plain, 0).grid_history.history

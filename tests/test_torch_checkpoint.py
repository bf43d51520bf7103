"""Checkpoints of the port (`spiking_neural_networks_tpu_torch.utils.
checkpoint`): the JAX package's four round trips (``tests/test_analysis.py``
and ``tests/test_review_regressions.py``) through the port, files of one
package loaded in the other, and a Poisson network resumed from a port
checkpoint against the run it was cut from.

Exact within one package (states, weights, traces and the generator are
restored bit for bit).  Across packages the loaded arrays are equal, and a
run continued in both agrees to rtol 1e-5 after one step and within 2 mV
and 2 steps of firing time after 1000 (the two packages sum in other
associations).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.utils import checkpoint as jck
from spiking_neural_networks_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)


def test_lattice_roundtrip(tmp_path):
    lat = snt.Lattice(snt.Izhikevich(), device="cpu")
    lat.populate(4, 4, gap_conductance=10.0)
    lat.connect_stencil(radius=1.5, seed=2)
    lat.run_lattice(50)
    v_mid = lat.voltages().copy()
    path = tmp_path / "ck.npz"
    tck.save_lattice(lat, path)
    lat.run_lattice(50)
    v_end = lat.voltages().copy()
    tck.load_lattice(lat, path)
    assert lat.internal_clock == 50
    np.testing.assert_array_equal(lat.voltages(), v_mid)
    assert lat.state["last_firing_time"].dtype == torch.int32
    assert lat.state["is_spiking"].dtype == torch.bool
    assert lat.graph.mask.dtype == torch.bool
    lat.run_lattice(50)
    np.testing.assert_array_equal(lat.voltages(), v_end)


def poisson_net(seed=0):
    exc = snt.Lattice(snt.Izhikevich(), id=0, device="cpu")
    exc.populate(4, 4, gap_conductance=10.0)
    exc.connect_stencil(radius=1.5, seed=2)
    exc.do_plasticity = True
    st = snt.SpikeTrainLattice(snt.PoissonSpikeTrain(), id=1, device="cpu")
    st.populate(4, 4)
    st.state = snt.PoissonSpikeTrain().init_from_firing_rate(
        16, hertz=500.0, dt=0.1, device="cpu")
    net = snt.LatticeNetwork.generate_network([exc], [st])
    net.seed = seed
    net.connect(1, 0, lambda a, b: a == b, lambda a, b: 30.0)
    return net, exc


@pytest.mark.parametrize("structured", [True, False])
def test_network_roundtrip_fresh_object(tmp_path, structured):
    """Reloading into a freshly built network reproduces the trajectory of
    the uninterrupted run bit for bit, Poisson draws included (the
    network's generator state is in the file)."""
    net, exc = poisson_net()
    net.structured = structured
    net.run_lattices(100)
    path = tmp_path / "net.npz"
    tck.save_network(net, path)
    net.run_lattices(100)
    v_ref = exc.state["v"].clone()
    w_ref = net.connections[(1, 0)][2].copy()
    net2, exc2 = poisson_net(seed=9)         # another seed: the file's wins
    net2.structured = structured
    tck.load_network(net2, path)
    assert net2.seed == 0
    net2.run_lattices(100)
    assert torch.equal(exc2.state["v"], v_ref)
    np.testing.assert_array_equal(net2.connections[(1, 0)][2], w_ref)
    assert net2.internal_clock == 200


def test_poisson_network_resumed_into_the_same_object(tmp_path):
    """Save, run on (``want``), load into the SAME network (its plans
    cached from the run) and run again (``got``): bit-equal, graph
    weights, connection weights, trains and clocks included."""
    net, exc = poisson_net()
    net.run_lattices(60)
    path = tmp_path / "same"                   # extensionless on purpose
    tck.save_network(net, str(path))
    net.run_lattices(80)
    want = ({k: v.clone() for k, v in exc.state.items()},
            exc.graph.weights.clone(), net.connections[(1, 0)][2].copy(),
            {k: v.clone()
             for k, v in net.spike_train_lattices[1].state.items()})
    assert net._structured_plan is not None
    version = net._conn_version
    tck.load_network(net, str(path))
    assert net._conn_version == version + 1
    assert net.internal_clock == 60 and exc.internal_clock == 60
    net.run_lattices(80)
    for k, v in want[0].items():
        assert torch.equal(exc.state[k], v), k
    assert torch.equal(exc.graph.weights, want[1])
    np.testing.assert_array_equal(net.connections[(1, 0)][2], want[2])
    for k, v in want[3].items():
        assert torch.equal(net.spike_train_lattices[1].state[k], v), k


def reward_lattice():
    lat = snt.RewardModulatedLattice(snt.Izhikevich(), device="cpu")
    lat.populate(4, 4, gap_conductance=10.0)
    lat.connect_stencil(radius=1.5)
    lat.apply(lambda s: {**s, "v": torch.full_like(s["v"], -20.0)})
    return lat


def test_reward_lattice_roundtrip(tmp_path):
    lat = reward_lattice()
    lat.run_lattice_with_reward(0.5, 100)
    path = tmp_path / "r.npz"
    tck.save_lattice(lat, path)
    dop = lat.dopamine
    lat.run_lattice_with_reward(0.5, 100)
    v_ref, c_ref = lat.state["v"].clone(), lat.trace["c"].clone()
    lat2 = reward_lattice()
    tck.load_lattice(lat2, path)
    assert lat2.dopamine == dop and lat2.trace["counter"].dtype == torch.int32
    lat2.run_lattice_with_reward(0.5, 100)
    assert torch.equal(lat2.state["v"], v_ref)
    assert torch.equal(lat2.trace["c"], c_ref)


def reward_net():
    rlat = snt.RewardModulatedLattice(snt.Izhikevich(), id=0, device="cpu")
    rlat.populate(2, 2, gap_conductance=10.0)
    rlat.connect_stencil(radius=1.0, seed=1)
    plain = snt.Lattice(snt.Izhikevich(), id=1, device="cpu")
    plain.populate(2, 2, gap_conductance=10.0)
    plain.connect_stencil(radius=1.0, seed=2)
    net = snt.RewardModulatedLatticeNetwork("cpu")
    net.add_lattice(rlat)
    net.add_lattice(plain)
    net.connect_with_reward_modulation(1, 0, lambda a, b: a == b,
                                       lambda a, b: 1.5)
    return net


def test_reward_network_roundtrip(tmp_path):
    net = reward_net()
    v0 = np.random.default_rng(3).uniform(-65, 40, 4).astype(np.float32)
    net.get_lattice(1).apply(lambda s: {**s, "v": torch.from_numpy(v0)})
    net.run_lattices_with_reward(0.6, 25)
    path = tmp_path / "ckpt"
    tck.save_network(net, str(path))
    fresh = reward_net()
    tck.load_network(fresh, str(path))
    ra, rb = net.get_reward_modulated_lattice(0), \
        fresh.get_reward_modulated_lattice(0)
    assert torch.equal(ra.state["v"], rb.state["v"])
    for f in ("c", "dw", "counter"):
        assert torch.equal(ra.trace[f], rb.trace[f])
    assert ra.dopamine == rb.dopamine and fresh.dopamine == net.dopamine
    for x, y in zip(net.reward_connections[(1, 0)],
                    fresh.reward_connections[(1, 0)]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    net.run_lattices_with_reward(0.6, 25)
    fresh.run_lattices_with_reward(0.6, 25)
    assert torch.equal(net.get_lattice(1).state["v"],
                       fresh.get_lattice(1).state["v"])


def jax_lattice(stdp=False):
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(6, 5, gap_conductance=10.0)
    lat.connect_stencil(radius=1.5, keep_prob=0.8, seed=4)
    v0 = np.random.default_rng(6).uniform(-65, 30, 30).astype(np.float32)
    lat.apply(lambda s: {**s, "v": jnp.asarray(v0)})
    lat.do_plasticity = stdp
    return lat


def port_lattice(stdp=False):
    lat = snt.Lattice(snt.Izhikevich(), device="cpu")
    lat.populate(6, 5, gap_conductance=10.0)
    lat.connect_stencil(radius=1.0)
    lat.do_plasticity = stdp
    return lat


def assert_state_equal(t, j):
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)


def assert_continued_close(t, j, steps):
    if steps == 1:
        np.testing.assert_allclose(t.state["v"].numpy(),
                                   np.asarray(j.state["v"]), rtol=1e-5,
                                   atol=1e-5)
        return
    tl = t.state["last_firing_time"].numpy()
    jl = np.asarray(j.state["last_firing_time"])
    assert np.abs(tl - jl).max() <= 2
    np.testing.assert_allclose(t.state["v"].numpy(),
                               np.asarray(j.state["v"]), atol=2.0)


@pytest.mark.parametrize("stdp", [False, True])
def test_jax_file_loads_in_port(tmp_path, stdp):
    j = jax_lattice(stdp)
    j.run_lattice(40)
    path = tmp_path / "jax.npz"
    jck.save_lattice(j, path)
    t = port_lattice(stdp)            # another graph: the file's wins
    t.run_lattice(3)
    tck.load_lattice(t, path)
    assert_state_equal(t.state, j.state)
    assert t.graph.offsets == j.graph.offsets
    np.testing.assert_array_equal(t.graph.weights.numpy(),
                                  np.asarray(j.graph.weights))
    np.testing.assert_array_equal(t.graph.in_deg.numpy(),
                                  np.asarray(j.graph.in_deg))
    assert t.internal_clock == 40
    j.run_lattice(1)
    t.run_lattice(1)
    assert_continued_close(t, j, 1)
    j.run_lattice(999)
    t.run_lattice(999)
    assert_continued_close(t, j, 1000)
    assert int((t.state["last_firing_time"] >= 40).sum()) > 0


def test_port_file_loads_in_jax(tmp_path):
    t = port_lattice(True)
    t.apply(lambda s: {**s, "v": torch.from_numpy(np.random.default_rng(
        2).uniform(-65, 30, 30).astype(np.float32))})
    t.run_lattice(40)
    path = tmp_path / "port.npz"
    tck.save_lattice(t, path)
    j = jax_lattice(True)
    jck.load_lattice(j, path)
    assert_state_equal(t.state, j.state)
    np.testing.assert_array_equal(t.graph.weights.numpy(),
                                  np.asarray(j.graph.weights))
    np.testing.assert_array_equal(t.graph.mask.numpy(),
                                  np.asarray(j.graph.mask))
    j.run_lattice(1)
    t.run_lattice(1)
    assert_continued_close(t, j, 1)
    j.run_lattice(999)
    t.run_lattice(999)
    assert_continued_close(t, j, 1000)


def test_reward_network_files_cross_packages(tmp_path):
    """A reward network (traces, dopamine, reward connections) written by
    the JAX package loads in the port, and the port's file in JAX."""
    import test_review_regressions as trr
    j = trr._reward_net()
    v0 = np.random.default_rng(3).uniform(-65, 40, 4).astype(np.float32)
    j.get_lattice(1).apply(lambda s: {**s, "v": jnp.asarray(v0)})
    j.run_lattices_with_reward(0.6, 25)
    jp = tmp_path / "j.npz"
    jck.save_network(j, jp)
    t = reward_net()
    tck.load_network(t, jp)
    for lid in (0, 1):
        assert_state_equal(t._neuron_lattices()[lid].state,
                           j._neuron_lattices()[lid].state)
    for f in ("c", "dw", "counter"):
        np.testing.assert_array_equal(
            t.get_reward_modulated_lattice(0).trace[f].numpy(),
            np.asarray(j.get_reward_modulated_lattice(0).trace[f]))
    for x, y in zip(t.reward_connections[(1, 0)],
                    j.reward_connections[(1, 0)]):
        np.testing.assert_array_equal(x, np.asarray(y))
    assert t.dopamine == pytest.approx(j.dopamine)
    t.run_lattices_with_reward(0.6, 25)
    tp = tmp_path / "t.npz"
    tck.save_network(t, tp)
    j2 = trr._reward_net()
    jck.load_network(j2, tp)
    assert_state_equal(t.get_lattice(1).state, j2.get_lattice(1).state)
    np.testing.assert_array_equal(
        t.get_reward_modulated_lattice(0).trace["c"].numpy(),
        np.asarray(j2.get_reward_modulated_lattice(0).trace["c"]))
    assert j2.internal_clock == 50

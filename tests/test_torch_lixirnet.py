"""The port's `lixirnet` (``spiking_neural_networks_tpu_torch/lixirnet.py``)
against the JAX package's on the same calls, on the CPU: each scenario of
``tests/test_lixirnet_compat.py`` (construction and run, get / set neuron,
`apply_given_position`, weights and connections, the electrical and
chemical networks, the ``*GPU`` copies, the legacy HH / LIF / Ionotropic
families, Destexhe and the ion channels, the Dopa* names, the type locks)
runs through both modules, and the results are compared.

Tolerances: values read back (weights, positions, parameters, host-side
prototype maths) equal; a run's states and histories within 2 mV of the
JAX package's at every step and firing times within 2 steps (the
CPU <-> GPU criterion of the reference, ``BASELINE.md``), and one step
within rtol 1e-5, atol 1e-4.  The port runs its plain route on the CPU
(``device="cpu"``); a Poisson train draws from another generator than
JAX's, so the Ionotropic network's cue fires with chance 1 (deterministic)
here.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import spiking_neural_networks_tpu.lixirnet as jln
import spiking_neural_networks_tpu_torch.lixirnet as tln

torch.set_num_threads(1)

MV, STEPS = 2.0, 2


class _OnCpu:
    """The port's `lixirnet` with every lattice class and ``*GPU`` copy
    on the CPU (the JAX module's calls, ``device="cpu"`` added)."""

    def __getattr__(self, name):
        obj = getattr(tln, name)
        if isinstance(obj, type) and issubclass(obj, tln._LatticeMixin) \
                and not name.endswith("GPU"):
            return functools.partial(obj, device="cpu")
        if name == "IzhikevichNeuronLatticeGPU":
            return _Proxy(from_lattice=functools.partial(
                obj.from_lattice, device="cpu"))
        if name == "IzhikevichNeuronNetworkGPU":
            return _Proxy(from_network=functools.partial(
                obj.from_network, device="cpu"))
        return obj


class _Proxy:
    def __init__(self, **kw):
        self.__dict__.update(kw)


TLN = _OnCpu()
MODULES = {"jax": jln, "torch": TLN}


def both(scenario):
    """``scenario(ln)`` through the JAX module, then the port's."""
    return scenario(jln), scenario(TLN)


def assert_runs_close(a, b):
    """Histories (T, ...) within 2 mV at every step."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.isfinite(b).all()
    assert np.abs(a - b).max() <= MV, float(np.abs(a - b).max())


def assert_firing_close(a, b):
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    assert ((a < 0) == (b < 0)).all()
    assert np.abs(a - b).max(initial=0) <= STEPS


def lft(lat):
    return np.asarray(lat.inner.state["last_firing_time"])


# -- construction and run ------------------------------------------------------


def build_exc_inh_network(ln, num_rows=5, num_cols=5, inh_rows=3,
                          inh_cols=3):
    glu_neuro = ln.BoundedNeurotransmitterKinetics(clearance_constant=0.001)
    gaba_neuro = ln.BoundedNeurotransmitterKinetics(clearance_constant=0.001)
    exc_nts = {ln.DopaGluGABANeurotransmitterType.Glutamate: glu_neuro}
    inh_nts = {ln.DopaGluGABANeurotransmitterType.GABA: gaba_neuro}
    glu = ln.GlutamateReceptor(ampa_r=ln.BoundedReceptorKinetics(r_max=10),
                               nmda_r=ln.BoundedReceptorKinetics(r_max=10))
    receptors = ln.DopaGluGABA()
    receptors.insert(ln.DopaGluGABANeurotransmitterType.Glutamate, glu)
    receptors.insert(ln.DopaGluGABANeurotransmitterType.GABA,
                     ln.GABAReceptor())
    exc_neuron = ln.IzhikevichNeuron()
    exc_neuron.set_synaptic_neurotransmitters(exc_nts)
    exc_neuron.set_receptors(receptors)
    inh_neuron = ln.IzhikevichNeuron()
    inh_neuron.set_synaptic_neurotransmitters(inh_nts)
    inh_neuron.set_receptors(receptors)

    exc_lattice = ln.IzhikevichNeuronLattice(0)
    exc_lattice.populate(exc_neuron, num_rows, num_cols)
    exc_lattice.connect(lambda x, y: x != y, lambda x, y: 1.0)
    rng = np.random.default_rng(42)
    exc_lattice.apply(lambda n: setattr(
        n, "current_voltage", float(rng.uniform(-65, 30))))
    exc_lattice.update_grid_history = True
    inh_lattice = ln.IzhikevichNeuronLattice(1)
    inh_lattice.populate(inh_neuron, inh_rows, inh_cols)
    inh_lattice.connect(lambda x, y: x != y, lambda x, y: 1.0)
    inh_lattice.apply(lambda n: setattr(
        n, "current_voltage", float(rng.uniform(-65, 30))))
    spike_train = ln.RateSpikeTrain()
    spike_train.set_synaptic_neurotransmitters(exc_nts)
    st_lattice = ln.RateSpikeTrainLattice(2)
    st_lattice.populate(spike_train, num_rows, num_cols)

    network = ln.IzhikevichNeuronNetwork()
    network.add_lattice(exc_lattice)
    network.add_lattice(inh_lattice)
    network.add_spike_train_lattice(st_lattice)
    network.connect(0, 1, lambda x, y: True, lambda x, y: 0.5)
    network.connect(1, 0, lambda x, y: True, lambda x, y: -0.8)
    network.connect(2, 0, lambda x, y: x == y, lambda x, y: 3.0)
    network.electrical_synapse = False
    network.chemical_synapse = True
    return network


def test_network_construction_and_run():
    def run(ln):
        network = build_exc_inh_network(ln)
        network.apply_spike_train_lattice_given_position(
            2, lambda pos, n: setattr(n, "rate", 10.0 if pos[0] < 3 else 0.0))
        network.run_lattices(500)
        return (np.stack(network.get_lattice(0).history),
                lft(network.get_lattice(0)), lft(network.get_lattice(1)))

    (hj, lj0, lj1), (ht, lt0, lt1) = both(run)
    assert ht.shape == (500, 5, 5)
    assert_runs_close(hj, ht)
    assert_firing_close(lj0, lt0)
    assert_firing_close(lj1, lt1)
    assert ht.max() >= -55.0


def test_one_step_matches_within_rtol():
    def run(ln):
        network = build_exc_inh_network(ln)
        network.apply_spike_train_lattice_given_position(
            2, lambda pos, n: setattr(n, "rate", 1.0))
        network.run_lattices(1)
        return {k: np.asarray(v) for k, v in
                network.get_lattice(0).inner.state.items()}

    sj, st = both(run)
    assert set(sj) == set(st)
    for k in sj:
        if sj[k].dtype.kind == "f":
            np.testing.assert_allclose(st[k], sj[k], rtol=1e-5, atol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(st[k], sj[k], err_msg=k)


def test_populate_installs_the_same_state():
    """populate's host install (neurotransmitters, receptors, the
    prototype's scalars) gives the JAX module's state key for key; the
    port's lands on its device."""
    def build(ln):
        net = build_exc_inh_network(ln)
        return {i: {k: np.asarray(v) for k, v in
                    net.get_lattice(i).inner.state.items()} for i in (0, 1)}

    sj, st = both(build)
    for i in (0, 1):
        assert set(sj[i]) == set(st[i])
        for k in sj[i]:
            np.testing.assert_array_equal(st[i][k], sj[i][k], err_msg=k)
    lat = tln.IzhikevichNeuronLattice(0, device="cpu")
    lat.populate(tln.IzhikevichNeuron(), 2, 3)
    assert lat.device == torch.device("cpu")
    assert all(t.device.type == "cpu" for t in lat.inner.state.values())
    assert tln.IzhikevichNeuronLattice(0).device == torch.device("cuda")


def test_get_set_neuron_roundtrip():
    def run(ln):
        lat = ln.IzhikevichNeuronLattice(0)
        lat.populate(ln.IzhikevichNeuron(), 3, 3)
        first = copy.copy(vars(lat.get_neuron(1, 2)))
        n = lat.get_neuron(1, 2)
        n.current_voltage = -42.0
        n.u = 17.0
        lat.set_neuron(1, 2, n)
        got = lat.get_neuron(1, 2)
        with pytest.raises(KeyError):
            lat.get_neuron(3, 0)
        return first, (got.current_voltage, got.u, got.last_firing_time,
                       got.is_spiking, got.c_m)

    (fj, gj), (ft, gt) = both(run)
    assert gt == gj == (-42.0, 17.0, None, False, 100.0)
    for k in ("current_voltage", "u", "a", "b", "c", "d", "v_th", "c_m",
              "dt", "gap_conductance", "last_firing_time", "is_spiking"):
        assert ft[k] == fj[k], k


def test_apply_given_position():
    def run(ln):
        lat = ln.IzhikevichNeuronLattice(0)
        lat.populate(ln.IzhikevichNeuron(), 4, 4)
        seen = []

        def f(pos, neuron):
            seen.append(pos)
            neuron.current_voltage = float(pos[0] * 10 + pos[1])

        lat.apply_given_position(f)
        return seen, np.asarray(lat.inner.state["v"])

    (pj, vj), (pt, vt) = both(run)
    assert pt == pj   # the visiting order, neuron by neuron
    np.testing.assert_array_equal(vt, vj)
    assert vt[2 * 4 + 3] == 23.0


def test_apply_copies_once_each_way(monkeypatch):
    """An apply over a lattice pulls its fields in one copy and pushes
    only the fields a callback changed, in one copy."""
    lat = tln.IzhikevichNeuronLattice(0, device="cpu")
    lat.populate(tln.IzhikevichNeuron(), 3, 4)
    pulls, pushes = [], []
    pull, push = tln._pull_state, tln._to_device
    monkeypatch.setattr(tln, "_pull_state",
                        lambda *a, **k: pulls.append(1) or pull(*a, **k))
    monkeypatch.setattr(tln, "_to_device",
                        lambda arrays, dev: pushes.append(sorted(arrays))
                        or push(arrays, dev))
    lat.apply(lambda n: setattr(n, "c_m", 25.0))
    assert pulls == [1] and pushes == [["c_m"]]
    lat.apply(lambda n: None)
    assert pulls == [1, 1] and pushes == [["c_m"]]
    assert lat.get_neuron(2, 3).c_m == 25.0


def test_weights_getter_and_plasticity_setter():
    def run(ln):
        lat = ln.IzhikevichNeuronLattice(0)
        lat.populate(ln.IzhikevichNeuron(), 3, 3)
        lat.connect(lambda x, y: x != y, lambda x, y: 2.0)
        w = lat.weights
        stdp = ln.STDP()
        stdp.a_plus = 1.5
        lat.plasticity = stdp
        lat.do_plasticity = True
        return w, dict(lat.plasticity.params), lat.do_plasticity

    (wj, pj, dj), (wt, pt, dt) = both(run)
    np.testing.assert_array_equal(wt, wj)
    assert pt == pj and pt["a_plus"] == 1.5 and dt is dj is True


def test_receptor_type_mismatch_raises():
    for ln in MODULES.values():
        receptors = ln.DopaGluGABA()
        with pytest.raises(ValueError):
            receptors.insert(ln.DopaGluGABANeurotransmitterType.GABA,
                             ln.GlutamateReceptor())


def test_lixirnet_matches_native_trajectory():
    """The port's lixirnet (electrical, dense graph) against the JAX
    package's native Lattice, as the JAX test holds its own lixirnet."""
    import jax.numpy as jnp
    import spiking_neural_networks_tpu as snn

    v_init = np.random.default_rng(7).uniform(-65, 30, 16).astype(np.float32)
    lat_ln = TLN.IzhikevichNeuronLattice(0)
    proto = tln.IzhikevichNeuron()
    proto.gap_conductance = 10.0
    lat_ln.populate(proto, 4, 4)
    lat_ln.connect(lambda x, y: x != y, lambda x, y: 1.0)
    lat_ln.apply_given_position(
        lambda pos, n: setattr(n, "current_voltage",
                               float(v_init[pos[0] * 4 + pos[1]])))
    lat_ln.update_grid_history = True
    lat_ln.run_lattice(200)
    got = np.stack(lat_ln.history)

    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(4, 4, gap_conductance=10.0)
    lat.connect(lambda x, y: x != y, lambda x, y: 1.0)
    lat.apply(lambda s: {**s, "v": jnp.asarray(v_init)})
    lat.update_grid_history = True
    lat.run_lattice(200)
    want = np.stack(lat.grid_history.history)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


# -- weights and connections ---------------------------------------------------


def _setup_voltages(init_state):
    def setup_neuron(pos, neuron):
        x, y = pos
        neuron.current_voltage = init_state[x][y]
        return neuron
    return setup_neuron


def test_lattice_get_weight_and_connections():
    def run(ln):
        exc_n = 3
        neuron = ln.IzhikevichNeuron()
        neuron.gap_conductance = 10
        neuron.c_m = 25
        init = np.random.default_rng(0).uniform(neuron.c, neuron.v_th,
                                                (exc_n, exc_n))
        lattice = ln.IzhikevichNeuronLattice(0)
        lattice.populate(neuron, exc_n, exc_n)
        lattice.apply_given_position(_setup_voltages(init))
        lattice.connect(lambda x, y: x != y, lambda x, y: 5)
        table = [lattice.get_weight((a, b), (c, d)) for a in range(3)
                 for b in range(3) for c in range(3) for d in range(3)]
        with pytest.raises(KeyError):
            lattice.get_weight((0, 0), (5, 5))
        out = [table, lattice.get_incoming_connections((1, 1)),
               lattice.get_outgoing_connections((0, 0))]
        lattice.edit_weight((0, 0), (1, 1), 9.5)
        out.append(lattice.get_weight((0, 0), (1, 1)))
        lattice.edit_weight((0, 0), (1, 1), None)
        out += [lattice.get_weight((0, 0), (1, 1)),
                lattice.get_outgoing_connections((0, 0)),
                lattice.weights, lattice.get_every_node(),
                lattice.position_to_index]
        return out

    j, t = both(run)
    for a, b in zip(j, t):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a)
        else:
            assert a == b
    assert t[3] == 9.5 and t[4] == 0.0 and (1, 1) not in t[5]


def test_network_get_weight_graph_positions():
    def run(ln):
        neuron = ln.IzhikevichNeuron()
        l0 = ln.IzhikevichNeuronLattice(0)
        l0.populate(neuron, 2, 2)
        l0.connect(lambda x, y: x != y, lambda x, y: 2.0)
        l1 = ln.IzhikevichNeuronLattice(1)
        l1.populate(neuron, 2, 2)
        net = ln.IzhikevichNeuronNetwork.generate_network([l0, l1])
        net.connect(0, 1, lambda x, y: x == y, lambda x, y: 3.0)
        gp = ln.GraphPosition
        out = [net.get_weight(gp(0, (0, 0)), gp(0, (0, 1))),
               net.get_weight(gp(0, (0, 1)), gp(1, (0, 1))),
               net.get_weight(gp(0, (0, 1)), gp(1, (1, 1))),
               net.get_incoming_connections_within_lattice(0, (0, 0))]
        with pytest.raises(KeyError):
            net.get_weight(gp(7, (0, 0)), gp(1, (0, 0)))
        net.edit_weight(gp(0, (0, 0)), gp(1, (0, 0)), 4.5)
        out.append(net.get_weight(gp(0, (0, 0)), gp(1, (0, 0))))
        net.run_lattices(5)
        out.append(np.asarray(net.get_lattice(1).inner.state["v"]))
        return out

    j, t = both(run)
    assert t[:5] == j[:5] == [2.0, 3.0, 0.0, {(0, 1), (1, 0), (1, 1)}, 4.5]
    np.testing.assert_allclose(t[5], j[5], rtol=1e-5, atol=1e-4)


# -- the *GPU copies -----------------------------------------------------------


def test_single_lattice_electrical_using_from():
    def run(ln):
        exc_n, iterations = 3, 1000
        neuron = ln.IzhikevichNeuron()
        neuron.gap_conductance = 10
        neuron.c_m = 25
        init = np.random.default_rng(5).uniform(neuron.c, neuron.v_th,
                                                (exc_n, exc_n))
        lattice = ln.IzhikevichNeuronLattice(0)
        lattice.populate(neuron, exc_n, exc_n)
        lattice.apply_given_position(_setup_voltages(init))
        lattice.connect(lambda x, y: x != y, lambda x, y: 5)
        lattice.update_grid_history = True
        lattice.electrical_synapse = True
        lattice.chemical_synapse = False
        gpu = ln.IzhikevichNeuronLatticeGPU.from_lattice(lattice)
        lattice.run_lattice(iterations)
        gpu.run_lattice(iterations)
        return (np.asarray(lattice.history), np.asarray(gpu.history),
                lattice, gpu)

    (hj, gj, _, _), (ht, gt, lat, gpu) = both(run)
    assert ht.shape == (1000, 3, 3)
    assert_runs_close(hj, ht)
    np.testing.assert_array_equal(gt, ht)
    # the copy shares no storage and stays on the lattice's device
    ptrs = {t.data_ptr() for t in lat.inner.state.values()}
    assert not ptrs & {t.data_ptr() for t in gpu.inner.state.values()}
    assert gpu.device == lat.device


def test_gpu_copy_of_a_network_after_a_run():
    """`from_network` of a network that has run (its cached plan holds
    ctypes and device buffers) copies it; the copy steps independently."""
    net = build_exc_inh_network(TLN)
    net.run_lattices(20)
    gpu = TLN.IzhikevichNeuronNetworkGPU.from_network(net)
    assert gpu.inner._structured_plan is None
    net.run_lattices(30)
    gpu.run_lattices(30)
    np.testing.assert_array_equal(np.stack(gpu.get_lattice(0).history),
                                  np.stack(net.get_lattice(0).history))
    a = {t.data_ptr() for t in net.get_lattice(0).inner.state.values()}
    b = {t.data_ptr() for t in gpu.get_lattice(0).inner.state.values()}
    assert not a & b


def test_network_surface_methods():
    def run(ln):
        neuron = ln.IzhikevichNeuron()
        l0 = ln.IzhikevichNeuronLattice(0)
        l0.populate(neuron, 2, 2)
        l0.connect(lambda x, y: x != y, lambda x, y: 2.0)
        st = ln.RateSpikeTrainLattice(2)
        st.populate(ln.RateSpikeTrain(rate=3.0), 2, 2)
        net = ln.IzhikevichNeuronNetwork.generate_network([l0], [st])
        net.connect(2, 0, lambda x, y: x == y, lambda x, y: 1.5)
        gp = ln.GraphPosition
        idx = net.get_connecting_position_to_index()
        out = [net.get_all_ids(), l0.get_every_node(),
               {(g.id, g.pos): i for g, i in idx.items()},
               net.get_connecting_weights(),
               {(g.id, g.pos) for g in
                net.get_incoming_connectings_across_lattices(0, (0, 1))},
               {(g.id, g.pos) for g in
                net.get_outgoing_connectings_across_lattices(2, (0, 1))}]
        t = net.get_spike_train(2, 0, 0)
        out.append(t.rate)
        t.rate = 7.0
        net.set_spike_train(2, 0, 0, t)
        out.append(net.get_spike_train(2, 0, 0).rate)
        l0.update_graph_history = True
        l0.do_plasticity = True
        net.run_lattices(20)
        out.append(np.stack(net.get_lattice(0).weights_history()))
        fresh = ln.IzhikevichNeuronLattice(0)
        fresh.populate(neuron, 2, 2)
        net.set_lattice(0, fresh)
        out.append(float(np.abs(net.get_connecting_weights()).sum()))
        out.append("IzhikevichNeuronNetwork" in repr(net))
        net.clear()
        out.append(net.get_all_ids())
        return out

    j, t = both(run)
    assert len(j) == len(t)
    for a, b in zip(j, t):
        if isinstance(a, np.ndarray):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4)
        else:
            assert a == b
    assert t[-1] == set() and t[6] == 3.0 and t[7] == 7.0


def test_network_electrical_using_from():
    def run(ln):
        e1, e2 = 0, 1
        neuron = ln.IzhikevichNeuron()
        neuron.gap_conductance = 10
        neuron.c_m = 25
        rng = np.random.default_rng(11)
        init1 = rng.uniform(neuron.c, neuron.v_th, (3, 3))
        init2 = rng.uniform(neuron.c, neuron.v_th, (2, 2))
        lattice1 = ln.IzhikevichNeuronLattice(e1)
        lattice1.populate(neuron, 3, 3)
        lattice1.apply_given_position(_setup_voltages(init1))
        lattice1.connect(lambda x, y: x != y, lambda x, y: 5)
        lattice1.update_grid_history = True
        lattice2 = ln.IzhikevichNeuronLattice(e2)
        lattice2.populate(neuron, 2, 2)
        lattice2.apply_given_position(_setup_voltages(init2))
        lattice2.connect(lambda x, y: x != y, lambda x, y: 3)
        lattice2.update_grid_history = True
        network = ln.IzhikevichNeuronNetwork.generate_network(
            [lattice1, lattice2], [])
        network.connect(e1, e2, lambda x, y: x == y, lambda x, y: 5)
        network.connect(e2, e1, lambda x, y: x == y, lambda x, y: 3)
        network.electrical_synapse = True
        network.chemical_synapse = False
        gpu = ln.IzhikevichNeuronNetworkGPU.from_network(network)
        w = network.get_connecting_weights()
        network.run_lattices(1000)
        gpu.run_lattices(1000)
        return [w] + [np.asarray(n.get_lattice(i).history)
                      for n in (network, gpu) for i in (e1, e2)]

    j, t = both(run)
    np.testing.assert_array_equal(t[0], j[0])
    for a, b in zip(j[1:], t[1:]):
        assert_runs_close(a, b)
    np.testing.assert_array_equal(t[1], t[3])
    np.testing.assert_array_equal(t[2], t[4])


def _dopa_network(ln):
    exc_n1, e1, c1, c2 = 4, 0, 1, 2

    def steps(init_state):
        def setup_spike_train(pos, neuron):
            x, y = pos
            neuron.step = init_state[x][y]
            return neuron
        return setup_spike_train

    exc_neuron = ln.IzhikevichNeuron()
    exc_neuron.gap_conductance = 10
    exc_neuron.c_m = 25
    exc_nts = {ln.DopaGluGABANeurotransmitterType.Glutamate:
               ln.BoundedNeurotransmitterKinetics()}
    dopa_nts = {ln.DopaGluGABANeurotransmitterType.Dopamine:
                ln.BoundedNeurotransmitterKinetics()}
    dopa = ln.DopamineReceptor()
    dopa.s_d1 = 1
    dopa.s_d2 = 0
    receptors = ln.DopaGluGABA()
    receptors.insert(ln.DopaGluGABANeurotransmitterType.Glutamate,
                     ln.GlutamateReceptor())
    receptors.insert(ln.DopaGluGABANeurotransmitterType.Dopamine, dopa)
    exc_neuron.set_synaptic_neurotransmitters(exc_nts)
    exc_neuron.set_receptors(receptors)
    rng = np.random.default_rng(13)
    exc_train = ln.RateSpikeTrain(rate=100)
    exc_train.set_synaptic_neurotransmitters(exc_nts)
    dopa_train = ln.RateSpikeTrain(rate=100)
    dopa_train.set_synaptic_neurotransmitters(dopa_nts)
    st1 = ln.RateSpikeTrainLattice(c1)
    st1.populate(exc_train, exc_n1, exc_n1)
    st1.apply_given_position(steps(rng.uniform(0, 100, (exc_n1, exc_n1))))
    st2 = ln.RateSpikeTrainLattice(c2)
    st2.populate(dopa_train, exc_n1, exc_n1)
    st2.apply_given_position(steps(rng.uniform(0, 100, (exc_n1, exc_n1))))
    lattice1 = ln.IzhikevichNeuronLattice(e1)
    lattice1.populate(exc_neuron, exc_n1, exc_n1)
    lattice1.apply_given_position(_setup_voltages(
        rng.uniform(exc_neuron.c, exc_neuron.v_th, (exc_n1, exc_n1))))
    lattice1.connect(lambda x, y: x != y, lambda x, y: 1)
    lattice1.update_grid_history = True
    network = ln.IzhikevichNeuronNetwork.generate_network(
        [lattice1], [st1, st2])
    network.connect(c1, e1, lambda x, y: x == y, lambda x, y: 1)
    network.connect(c2, e1, lambda x, y: x == y, lambda x, y: 1)
    network.electrical_synapse = False
    network.chemical_synapse = True
    network.parallel = True
    network.set_dt(1)
    return network


def test_dopamine_network_chemical_drive():
    def run(ln):
        network = _dopa_network(ln)
        gpu = ln.IzhikevichNeuronNetworkGPU.from_network(network)
        network.run_lattices(1000)
        gpu.run_lattices(1000)
        return (np.asarray(network.get_lattice(0).history),
                np.asarray(gpu.get_lattice(0).history),
                lft(network.get_lattice(0)))

    (hj, _, lj), (ht, gt, lt) = both(run)
    assert_runs_close(hj, ht)
    assert_firing_close(lj, lt)
    np.testing.assert_array_equal(gt, ht)
    assert ht.max() > 0.0 and (lt >= 0).any()


def test_network_chemical_various_neurotransmitters():
    def run(ln):
        e1, i1, c1, c2 = 0, 2, 4, 5

        def steps(init_state):
            def setup(pos, neuron):
                neuron.step = init_state[pos[0]][pos[1]]
                return neuron
            return setup

        exc_neuron = ln.IzhikevichNeuron(gap_conductance=10, c_m=25)
        inh_neuron = ln.IzhikevichNeuron(gap_conductance=10, c_m=25)
        kin = ln.BoundedNeurotransmitterKinetics
        types = ln.DopaGluGABANeurotransmitterType
        exc_nts = {types.Glutamate: kin()}
        inh_nts = {types.GABA: kin()}
        dopa_nts = {types.Dopamine: kin()}
        dopa = ln.DopamineReceptor(s_d1=1, s_d2=0)
        receptors = ln.DopaGluGABA()
        receptors.insert(types.Glutamate, ln.GlutamateReceptor())
        receptors.insert(types.GABA, ln.GABAReceptor())
        receptors.insert(types.Dopamine, dopa)
        exc_neuron.set_synaptic_neurotransmitters(exc_nts)
        exc_neuron.set_receptors(receptors)
        inh_neuron.set_synaptic_neurotransmitters(inh_nts)
        inh_neuron.set_receptors(receptors)
        exc_train = ln.RateSpikeTrain(rate=100)
        exc_train.set_synaptic_neurotransmitters(exc_nts)
        dopa_train = ln.RateSpikeTrain(rate=100)
        dopa_train.set_synaptic_neurotransmitters(dopa_nts)
        rng = np.random.default_rng(17)
        st1 = ln.RateSpikeTrainLattice(c1)
        st1.populate(exc_train, 3, 3)
        st1.apply_given_position(steps(rng.uniform(0, 100, (3, 3))))
        st1.update_grid_history = True
        st2 = ln.RateSpikeTrainLattice(c2)
        st2.populate(dopa_train, 3, 3)
        st2.apply_given_position(steps(rng.uniform(0, 100, (3, 3))))
        st2.update_grid_history = True
        lattice1 = ln.IzhikevichNeuronLattice(e1)
        lattice1.populate(exc_neuron, 3, 3)
        lattice1.apply_given_position(_setup_voltages(
            rng.uniform(exc_neuron.c, exc_neuron.v_th, (3, 3))))
        lattice1.connect(lambda x, y: x != y, lambda x, y: 1)
        lattice1.update_grid_history = True
        lattice2 = ln.IzhikevichNeuronLattice(i1)
        lattice2.populate(inh_neuron, 2, 2)
        lattice2.apply_given_position(_setup_voltages(
            rng.uniform(inh_neuron.c, inh_neuron.v_th, (2, 2))))
        lattice2.connect(lambda x, y: x != y, lambda x, y: 0.5)
        lattice2.update_grid_history = True
        network = ln.IzhikevichNeuronNetwork.generate_network(
            [lattice1, lattice2], [st1, st2])
        network.connect(e1, i1, lambda x, y: x == y, lambda x, y: 2)
        network.connect(i1, e1, lambda x, y: x == y, lambda x, y: 1)
        network.connect(c1, e1, lambda x, y: x == y, lambda x, y: 3)
        network.connect(c2, e1, lambda x, y: x == y, lambda x, y: 1)
        network.electrical_synapse = False
        network.chemical_synapse = True
        network.run_lattices(1000)
        return [np.asarray(network.get_spike_train_lattice(c).history)
                for c in (c1, c2)] + \
            [np.asarray(network.get_lattice(i).history) for i in (e1, i1)]

    j, t = both(run)
    for a, b in zip(j[:2], t[:2]):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(j[2:], t[2:]):
        assert_runs_close(a, b)
    assert t[2].max() > 20.0


# -- the legacy families -------------------------------------------------------


def _legacy_run(ln, lat_name, proto, set_up, steps, radius_seed):
    lat = getattr(ln, lat_name)(0)
    lat.populate(proto, 4, 4)
    lat.apply(set_up)
    lat.connect_stencil(radius=1.5, keep_prob=0.9, seed=radius_seed)
    lat.update_grid_history = True
    lat.run_lattice(steps)
    n = lat.get_neuron(0, 0)
    return np.stack(lat.history), type(n).__name__, n.current_voltage


def _voltage_setter(v0):
    k = [0]

    def set_v(n):
        n.current_voltage = float(v0[k[0]])
        k[0] += 1
        return n
    return set_v


def test_legacy_hodgkin_huxley_lattice():
    v0 = np.random.default_rng(0).uniform(-70, -50, 16).astype(np.float32)

    def run(ln):
        proto = ln.HodgkinHuxleyNeuron()
        proto.c_m = 1.0
        return _legacy_run(ln, "HodgkinHuxleyLattice", proto,
                           _voltage_setter(v0), 500, 3)

    (hj, cj, vj), (ht, ct, vt) = both(run)
    assert ht.shape == (500, 4, 4) and ct == cj == "HodgkinHuxleyNeuron"
    assert_runs_close(hj, ht)
    assert abs(vt - float(ht[-1, 0, 0])) < 1e-4


def test_legacy_lif_lattice():
    v0 = np.random.default_rng(1).uniform(-75, -50, 16).astype(np.float32)

    def run(ln):
        proto = ln.LeakyIntegrateAndFireNeuron()
        proto.gap_conductance = 10.0
        return _legacy_run(ln, "LeakyIntegrateAndFireLattice", proto,
                           _voltage_setter(v0), 400, 4)

    (hj, _, _), (ht, ct, _) = both(run)
    assert ct == "LeakyIntegrateAndFireNeuron"
    assert_runs_close(hj, ht)


def test_legacy_izhikevich_ionotropic_network():
    """The legacy schizophrenia-pipeline construction (Approximate AMPA /
    NMDA neurotransmitters and ligand gates, a Poisson cue through
    chemical synapses) in both modules; the cue fires with chance 1."""
    v0 = np.random.default_rng(2).uniform(-65, 20, 9).astype(np.float32)

    def run(ln):
        nts = ln.ApproximateNeurotransmitters()
        nts.set_neurotransmitter(ln.IonotropicNeurotransmitterType.AMPA,
                                 ln.ApproximateNeurotransmitter(
                                     clearance_constant=0.005))
        nts.set_neurotransmitter(ln.IonotropicNeurotransmitterType.NMDA,
                                 ln.ApproximateNeurotransmitter())
        ampa = ln.ApproximateLigandGatedChannel(
            ln.IonotropicNeurotransmitterType.AMPA)
        ampa.g = 2.0
        nmda = ln.ApproximateLigandGatedChannel(
            ln.IonotropicNeurotransmitterType.NMDA)
        gates = ln.ApproximateLigandGatedChannels()
        gates.set_ligand_gate(ln.IonotropicNeurotransmitterType.AMPA, ampa)
        gates.set_ligand_gate(ln.IonotropicNeurotransmitterType.NMDA, nmda)
        neuron = ln.IzhikevichNeuron()
        neuron.c_m = 25.0
        neuron.set_neurotransmitters(nts)
        neuron.set_ligand_gates(gates)
        lat = ln.IzhikevichLattice(0)
        lat.populate(neuron, 3, 3)
        lat.apply(_voltage_setter(v0))
        lat.update_grid_history = True
        lat.connect_stencil(radius=1.5, keep_prob=1.0, seed=5)
        cue = ln.PoissonLattice(1)
        cue.populate(ln.PoissonNeuron(chance_of_firing=1.0), 3, 3)
        st_model = cue.inner.model
        cue.inner.state = st_model.insert_neurotransmitter(
            dict(cue.inner.state), "AMPA", clearance_constant=0.005)
        net = ln.IzhikevichNetwork.generate_network([lat], [cue])
        net.connect(1, 0, lambda x, y: x == y, lambda x, y: 50.0)
        net.inner.chemical_synapse = True
        net.run_lattices(300)
        return np.stack(lat.history), lft(net.get_lattice(0))

    (hj, lj), (ht, lt) = both(run)
    assert_runs_close(hj, ht)
    assert_firing_close(lj, lt)
    assert (lt >= 0).any()


def test_destexhe_neurotransmitters_and_receptors():
    def run(ln):
        t = ln.IonotropicNeurotransmitterType
        types = [t.AMPA, t.NMDA, t.GABAa, t.GABAb]
        nts = ln.DestexheNeurotransmitters(types)
        out = []
        for v in (-70.0, -10.0, 2.0, 25.0):
            nts.apply_t_changes(v, 0.1)
            out.append([nts[k].t for k in types])
        custom = ln.DestexheNeurotransmitter(t_max=2.0, v_p=5.0, k_p=2.0)
        nts.set_neurotransmitter(t.AMPA, custom)
        out.append(nts[t.AMPA].t_max)
        with pytest.raises(KeyError):
            ln.DestexheNeurotransmitters([])[t.AMPA]
        rec = ln.DestexheReceptor(r=0.2, alpha=1.5, beta=0.3)
        for conc in (0.0, 0.4, 1.0, 0.7):
            rec.apply_r_change(conc, 0.1)
            out.append(rec.r)
        gates = ln.DestexheLigandGatedChannels([t.AMPA, t.NMDA])
        ampa, nmda = gates[t.AMPA], gates[t.NMDA]
        out.append((ampa.g, ampa.reversal, nmda.mg))
        r0 = nmda.receptor.r
        gates.update_receptor_kinetics({t.AMPA: 0.8}, 0.1)
        out.append((gates[t.AMPA].receptor.r, nmda.receptor.r == r0))
        fresh = ln.DestexheReceptor(r=0.5, alpha=2.0, beta=0.1)
        ampa.set_receptor(fresh)
        out.append(ampa.get_receptor() is fresh)
        out.append(ln.DestexheLigandGatedChannel(t.GABAb).reversal)
        return out

    j, t = both(run)
    assert t == j
    assert t[-1] < -90.0 and t[-2] is True


def test_ion_channel_pyclasses():
    """The host pyclasses of both modules step alike, and match the
    port's vectorized channels (``models/ion_channels.py``)."""
    from spiking_neural_networks_tpu_torch.models import ion_channels as ic

    def run(ln):
        na = ln.NaIonChannel(g_na=120.0, e_na=50.0)
        k = ln.KIonChannel(g_k=36.0, e_k=-77.0)
        kleak = ln.KLeakChannel(g_k_leak=0.3, e_k_leak=-55.0)
        out = []
        for v in (-65.0, -41.0, -20.0, 10.0):
            na.update_current(v, 0.01)
            k.update_current(v, 0.01)
            kleak.update_current(v)
            out.append((na.current, k.current, kleak.current))
        gate = ln.BasicGatingVariable(alpha=0.5, beta=1.5)
        gate.init_state()
        gate.update(0.1)
        out.append(gate.state)
        out.append((ln.NaIonChannel().e_na, ln.KIonChannel().e_k,
                    ln.KLeakChannel().e_k_leak))
        return out

    j, t = both(run)
    assert t == j
    f = lambda x: torch.tensor(x, dtype=torch.float32)
    s = {"na$g": f(120.0), "na$e": f(50.0), "na$m_state": f(0.0),
         "na$h_state": f(0.0), "k$g": f(36.0), "k$e": f(-77.0),
         "k$n_state": f(0.0), "kleak$g": f(0.3), "kleak$e": f(-55.0)}
    for (na, k, kl), v in zip(t[:4], (-65.0, -41.0, -20.0, 10.0)):
        na_out = ic.na_channel_update(s, f(v), f(0.01))
        k_out = ic.k_channel_update(s, f(v), f(0.01))
        kl_out = ic.k_leak_channel_update(s, f(v))
        s.update(na_out)
        s.update(k_out)
        np.testing.assert_allclose(na, float(na_out["na$current"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(k, float(k_out["k$current"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(kl, float(kl_out["kleak$current"]),
                                   rtol=1e-5, atol=1e-6)


def test_legacy_dopa_izhikevich_neuron_host_step():
    def run(ln):
        n = ln.DopaIzhikevichNeuron()
        out = [(n.current_voltage, n.w_value)]
        for i in (10.0, 40.0, 40.0, 0.0, 40.0) * 40:
            out.append((n.iterate_and_spike(i), n.current_voltage,
                        n.w_value))
        return out

    j, t = both(run)
    assert t == j and t[0] == (-65.0, 30.0)


def test_legacy_dopa_lattice_and_network():
    v0 = np.random.default_rng(7).uniform(-65, 20, 9).astype(np.float32)

    def run(ln):
        def build(lat_cls, st_cls, neuron, train):
            lat = getattr(ln, lat_cls)(0)
            lat.populate(neuron, 3, 3)
            lat.apply(_voltage_setter(v0))
            lat.connect(lambda x, y: x != y, lambda x, y: 1.0)
            lat.update_grid_history = True
            st = getattr(ln, st_cls)(1)
            st.populate(train, 3, 3)
            net = ln.DopaIzhikevichNetwork.generate_network([lat], [st])
            net.connect(1, 0, lambda a, b: a == b, lambda a, b: 5.0)
            net.chemical_synapse = True
            net.run_lattices(200)
            return np.stack(net.get_lattice(0).history)

        types = ln.DopaGluGABANeurotransmitterType
        legacy_rec = ln.DopaGluGABAReceptors()
        legacy_rec.set_receptor(types.Glutamate, ln.GlutamateReceptor())
        legacy_nts = ln.DopaGluGABAApproximateNeurotransmitters(
            [types.Glutamate])
        legacy_neuron = ln.DopaIzhikevichNeuron(
            synaptic_neurotransmitters=legacy_nts, receptors=legacy_rec)
        legacy_train = ln.DopaPoissonNeuron(chance_of_firing=0.0)
        legacy_train.rate = 3.0
        legacy_train.set_synaptic_neurotransmitters(legacy_nts)
        v04_rec = ln.DopaGluGABA()
        v04_rec.insert(types.Glutamate, ln.GlutamateReceptor())
        v04_neuron = ln.IzhikevichNeuron(current_voltage=-65.0)
        v04_neuron.set_synaptic_neurotransmitters(
            {types.Glutamate:
             ln.BoundedNeurotransmitterKinetics(clearance_constant=0.01)})
        v04_neuron.set_receptors(v04_rec)
        v04_train = ln.RateSpikeTrain(rate=3.0)
        v04_train.set_synaptic_neurotransmitters(
            {types.Glutamate:
             ln.BoundedNeurotransmitterKinetics(clearance_constant=0.01)})
        legacy = build("DopaIzhikevichLattice", "DopaPoissonLattice",
                       legacy_neuron, legacy_train)
        v04 = build("IzhikevichNeuronLattice", "RateSpikeTrainLattice",
                    v04_neuron, v04_train)
        lat = ln.DopaIzhikevichLattice(0)
        lat.populate(legacy_neuron, 3, 3)
        n = lat.get_neuron(1, 2)
        first = (type(n).__name__, n.w_value, n.current_voltage)
        lat.set_neuron(1, 2, ln.DopaIzhikevichNeuron(w_value=11.0,
                                                     current_voltage=-30.0))
        again = lat.get_neuron(1, 2)
        return legacy, v04, first, (again.w_value, again.current_voltage)

    (lj, vj, fj, aj), (lt, vt, ft, at) = both(run)
    assert_runs_close(lj, lt)
    assert_runs_close(vj, vt)
    assert ft == fj == ("DopaIzhikevichNeuron", 30.0, -65.0)
    assert at == aj == (11.0, -30.0)


def test_legacy_network_classes_are_type_locked():
    for ln in MODULES.values():
        hh = ln.HodgkinHuxleyLattice(0)
        hh.populate(ln.HodgkinHuxleyNeuron(), 2, 2)
        izh = ln.IzhikevichLattice(1)
        izh.populate(ln.IzhikevichNeuron(), 2, 2)
        lif = ln.LeakyIntegrateAndFireLattice(2)
        lif.populate(ln.LeakyIntegrateAndFireNeuron(), 2, 2)
        net = ln.HodgkinHuxleyNetwork()
        net.add_lattice(hh)
        assert net.get_lattice(0) is hh
        with pytest.raises(TypeError, match="HodgkinHuxley"):
            net.add_lattice(izh)
        with pytest.raises(TypeError):
            ln.IzhikevichNetwork.generate_network([hh], [])
        with pytest.raises(TypeError):
            ln.LeakyIntegrateAndFireNetwork.generate_network([izh], [])
        ok = ln.LeakyIntegrateAndFireNetwork.generate_network([lif], [])
        assert ok.get_lattice(2) is lif
        cue = ln.PoissonLattice(3)
        cue.populate(ln.PoissonNeuron(chance_of_firing=0.0), 2, 2)
        ok.add_spike_train_lattice(cue)
        assert ok.get_spike_train_lattice(3) is cue


def test_a_network_raises_on_a_mix_of_devices():
    from spiking_neural_networks_tpu_torch.errors import LatticeNetworkError
    a = tln.IzhikevichNeuronLattice(0, device="cpu")
    a.populate(tln.IzhikevichNeuron(), 2, 2)
    b = tln.IzhikevichNeuronLattice(1, device="meta")
    b.inner.rows = b.inner.cols = 2
    net = tln.IzhikevichNeuronNetwork.generate_network([a])
    assert net.inner.device == torch.device("cpu")
    with pytest.raises(LatticeNetworkError):
        net.add_lattice(b)


def test_gpu_copy_moves_every_tensor_to_its_device():
    """`from_lattice` / `from_network` onto another device (the card by
    default; here the meta device, which has no data) move the members'
    states and graphs there and leave the source where it was."""
    net = build_exc_inh_network(TLN)
    lat = net.get_lattice(0)
    copy_lat = tln.IzhikevichNeuronLatticeGPU.from_lattice(lat,
                                                           device="meta")
    copy_net = tln.IzhikevichNeuronNetworkGPU.from_network(net,
                                                           device="meta")
    assert copy_lat.device == torch.device("meta")
    assert all(t.is_meta for t in copy_lat.inner.state.values())
    assert copy_lat.inner.graph.weights.is_meta
    members = list(copy_net.inner.lattices.values()) \
        + list(copy_net.inner.spike_train_lattices.values())
    assert copy_net.inner.device == torch.device("meta")
    assert all(m.device == torch.device("meta") for m in members)
    assert all(t.is_meta for m in members for t in m.state.values())
    assert all(t.device.type == "cpu" for t in lat.inner.state.values())
    assert copy_net.get_lattice(1).inner is copy_net.inner.lattices[1]

"""Builders shared by the network tests of the PyTorch port: JAX networks
with the topologies of ``tests/test_pallas_reward.py`` (`_plain_net`,
`_mixed_net`, `_network`), carried into the port with
`convert.network_from` / `convert.reward_network_from`, and the
comparison of the two after a run."""

import numpy as np
import jax.numpy as jnp

import spiking_neural_networks_tpu as snn
from spiking_neural_networks_tpu_torch.convert import (network_from,
                                                       reward_network_from)

MODELS = {"izhikevich": snn.Izhikevich,
          "alif": snn.AdaptiveLeakyIntegrateAndFire,
          "lif": snn.LeakyIntegrateAndFire}
TRAINS = {"rate": snn.RateSpikeTrain, "poisson": snn.PoissonSpikeTrain}


def _train(kind, rows, cols, hertz, refractoriness="delta_dirac"):
    st = snn.SpikeTrainLattice(TRAINS[kind](refractoriness=refractoriness),
                               id=2)
    st.populate(rows, cols)
    n = rows * cols
    if kind == "poisson":
        st.state = st.model.init_from_firing_rate(n, hertz=hertz, dt=0.1)
    else:
        st.state = st.model.init_state(n, rate=1.0, dt=0.1)
    return st


def _past_firing(lat, rng):
    """30% of the lattice's neurons fired at a step in [0, 3), so that STDP
    has pairs from the first step on; the network clock starts at 3."""
    n = lat.rows * lat.cols
    lft = np.where(rng.random(n) < 0.3, rng.integers(0, 3, n),
                   -1).astype(np.int32)
    lat.apply(lambda s: {**s, "last_firing_time": jnp.asarray(lft)})


def plain_net(model, train="rate", rows=8, cols=8, seed=6, plastic_a=True,
              plastic_b=True, refractoriness="delta_dirac", w_train=30.0):
    """Two lattices of ``model`` (radius 2 / keep 0.8 and radius 1.5 /
    keep 0.9, both plastic by default), a train driving the first one to
    one and the first driving the second one to one."""
    rng = np.random.default_rng(seed)
    n = rows * cols
    lats = []
    for lid, (radius, keep, gseed) in enumerate(((2.0, 0.8, 3),
                                                 (1.5, 0.9, 4))):
        lat = snn.Lattice(MODELS[model](), id=lid)
        lat.populate(rows, cols, gap_conductance=10.0)
        lat.connect_stencil(radius=radius, keep_prob=keep, seed=gseed)
        lo, hi = (-65.0, 30.0) if model == "izhikevich" else (-75.0, -50.0)
        v0 = rng.uniform(lo, hi, n)
        lat.apply(lambda s, v0=v0: {**s, "v": jnp.asarray(v0, jnp.float32)})
        _past_firing(lat, rng)
        lats.append(lat)
    lats[0].do_plasticity = plastic_a
    lats[1].do_plasticity = plastic_b
    st = _train(train, rows, cols, 80.0, refractoriness)
    net = snn.LatticeNetwork.generate_network(lats, [st])
    net.connect(2, 0, lambda x, y: x == y, lambda x, y: w_train)
    net.connect(0, 1, lambda x, y: x == y, lambda x, y: 8.0)
    net.internal_clock = 3
    return net


def mixed_net(train="rate", rows=8, cols=8, hist=None, w_pool=0.5,
              w_up=-0.8, w_train=25.0, hertz=80.0, v0=(-75.0, -50.0)):
    """A plastic Izhikevich excitatory grid, a half-size inhibitory grid
    wired to it by pooling and upsampling resample connections, and a
    train driving the excitatory grid one to one (the topology of
    BASELINE config 5); initial v uniform over ``v0``."""
    rng = np.random.default_rng(11)
    exc = snn.Lattice(snn.Izhikevich(), id=0)
    exc.populate(rows, cols, gap_conductance=10.0)
    exc.connect_stencil(radius=2.0, keep_prob=0.8, seed=5)
    exc.do_plasticity = True
    exc.apply(lambda s: {**s, "v": jnp.asarray(
        rng.uniform(*v0, rows * cols), jnp.float32)})
    if hist is not None:
        exc.grid_history = hist
        exc.update_grid_history = True
    inh = snn.Lattice(snn.Izhikevich(), id=1)
    inh.populate(rows // 2, cols // 2, gap_conductance=10.0)
    inh.connect_stencil(radius=1.5, seed=6)
    inh.apply(lambda s: {**s, "v": jnp.asarray(
        rng.uniform(*v0, rows * cols // 4), jnp.float32)})
    for lat in (exc, inh):
        _past_firing(lat, rng)
    st = _train(train, rows, cols, hertz)
    net = snn.LatticeNetwork.generate_network([exc, inh], [st])
    net.connect(2, 0, lambda x, y: x == y, lambda x, y: w_train)
    net.connect_vectorized(0, 1, lambda pr, pc, qr, qc: np.where(
        (pr // 2 == qr) & (pc // 2 == qc), w_pool, np.nan))
    net.connect_vectorized(1, 0, lambda pr, pc, qr, qc: np.where(
        (pr == qr // 2) & (pc == qc // 2), w_up, np.nan))
    net.internal_clock = 3
    return net


def both(build, use_pallas, use_kernel):
    """The JAX network of ``build()`` (``use_pallas``) and the port's
    copy of it (``use_kernel``), before any step."""
    j = build()
    j.use_pallas = use_pallas
    t = network_from(j, "cpu")
    t.use_kernel = use_kernel
    return j, t


def assert_networks_match(t, j, rtol, atol):
    """Every lattice's state and graph weights, every train's state and
    every connection's host weights of port network ``t`` against JAX
    network ``j``: integers and spikes equal, floats within
    ``rtol``/``atol``."""
    assert t.internal_clock == j.internal_clock
    for lid, jl in j.lattices.items():
        tl = t.lattices[lid]
        assert set(tl.state) == set(jl.state)
        for k in ("v", "w", "refractory_count"):
            if k in jl.state:
                np.testing.assert_allclose(
                    tl.state[k].numpy(), np.asarray(jl.state[k]), rtol=rtol,
                    atol=atol, err_msg=f"{k} of lattice {lid}")
        for k in ("last_firing_time", "is_spiking"):
            np.testing.assert_array_equal(
                tl.state[k].numpy(), np.asarray(jl.state[k]),
                err_msg=f"{k} of lattice {lid}")
        np.testing.assert_allclose(tl.graph.weights.numpy(),
                                   np.asarray(jl.graph.weights), rtol=rtol,
                                   atol=atol, err_msg=f"weights {lid}")
        assert tl.internal_clock == jl.internal_clock
    for sid, js in j.spike_train_lattices.items():
        ts = t.spike_train_lattices[sid]
        for k in ("last_firing_time", "is_spiking"):
            np.testing.assert_array_equal(ts.state[k].numpy(),
                                          np.asarray(js.state[k]),
                                          err_msg=f"{k} of train {sid}")
        for k in ("v", "step"):
            if k in js.state:
                np.testing.assert_allclose(ts.state[k].numpy(),
                                           np.asarray(js.state[k]),
                                           rtol=rtol, atol=atol, err_msg=k)
    assert set(t.connections) == set(j.connections)
    for key, (s, d, w) in j.connections.items():
        ts_, td, tw = t.connections[key]
        np.testing.assert_array_equal(ts_, np.asarray(s))
        np.testing.assert_array_equal(td, np.asarray(d))
        np.testing.assert_allclose(tw, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=str(key))


def chem_net(family="ionotropic", rec="approximate", nt="approximate",
             dopamine=False, resample=False, history=False, **kw):
    """The chemical network of ``tests/test_pallas_chem.py`` (`_chem_net`:
    two 8x8 lattices, lattice 0 driving lattice 1 one to one, a train
    driving lattice 0; ``kw`` passes ``electrical``, ``plastic``, ``train``,
    ``rows``, ``cols``), with options: ``dopamine``, a third lattice
    releasing dopamine into lattice 1 (one to one), whose D1 and D2
    receptors (s_d1 0.5, s_d2 0.3) move nmda_mod and inh_mod from 1 once
    it fires (v0 up to 40 mV: a third fires at once); ``resample``, a 4x4
    lattice pooled from lattice 0 (a resample connection, which the
    chemical arm leaves to the plain route); ``history``, a grid history
    on lattice 0."""
    from test_pallas_chem import _chem_net, _mk_model
    net = _chem_net(family=family, rec_kinetics=rec, nt_kinetics=nt, **kw)
    rows, cols = net.lattices[0].rows, net.lattices[0].cols
    n = rows * cols
    if dopamine:
        dopa = snn.Lattice(_mk_model(family, rec, nt), id=3)
        dopa.populate(rows, cols, gap_conductance=10.0)
        dopa.connect_stencil(radius=1.0, seed=9)
        s = dict(dopa.model.insert_neurotransmitter(dopa.state, "Dopamine"))
        s["v"] = jnp.asarray(np.random.default_rng(8).uniform(-65, 40, n),
                             jnp.float32)
        dopa.state = s
        net.add_lattice(dopa)
        l1 = net.lattices[1]
        l1.state = l1.model.insert_receptor(l1.state, "Dopamine", s_d1=0.5,
                                            s_d2=0.3)
        net.connect(3, 1, lambda x, y: x == y, lambda x, y: 1.0)
    if resample:
        pool = snn.Lattice(_mk_model(family, rec, nt), id=4)
        pool.populate(rows // 2, cols // 2, gap_conductance=10.0)
        pool.connect_stencil(radius=1.0, seed=10)
        name = "Glutamate" if family == "dopaglugaba" else "AMPA"
        pool.state = pool.model.insert_receptor(pool.state, name, g=25.0,
                                                e=60.0) \
            if family != "dopaglugaba" else pool.model.insert_receptor(
                pool.state, name, g_ampa=25.0, e_ampa=60.0)
        net.add_lattice(pool)
        net.connect_vectorized(0, 4, lambda pr, pc, qr, qc: np.where(
            (pr // 2 == qr) & (pc // 2 == qc), 0.5, np.nan))
    if history:
        net.lattices[0].update_grid_history = True
    return net


def reward_net(train="rate", model="izhikevich", seed=2, n_side=8):
    """The reward network of ``tests/test_pallas_reward.py`` (`_network`:
    a `RewardModulatedLattice` on the radius-2 predicate, a plastic
    lattice (radius 2, keep 0.8) driven one to one by a train (5.0 or,
    for ALIF, 30.0), and a reward connection from the plastic lattice to
    the reward lattice one to one); ``model="alif"`` is the all-ALIF form
    of ``test_fused_reward_network_alif`` (v0 in [-75, -50) in both
    lattices, a Rate train)."""
    from test_pallas_reward import _network
    if model == "izhikevich":
        return _network(TRAINS[train](), seed=seed, n_side=n_side)
    rng = np.random.default_rng(seed)
    n = n_side * n_side
    rlat = snn.RewardModulatedLattice(MODELS[model](), id=0)
    rlat.populate(n_side, n_side, gap_conductance=10.0)
    rlat.connect(lambda x, y: np.hypot(x[0] - y[0], x[1] - y[1]) <= 2
                 and x != y)
    rlat.apply(lambda s: {**s, "v": jnp.asarray(
        rng.uniform(-75, -50, n), jnp.float32)})
    plain = snn.Lattice(MODELS[model](), id=1)
    plain.populate(n_side, n_side, gap_conductance=10.0)
    plain.connect_stencil(radius=2.0, keep_prob=0.8, seed=4)
    plain.do_plasticity = True
    plain.apply(lambda s: {**s, "v": jnp.asarray(
        rng.uniform(-75, -50, n), jnp.float32)})
    st = _train(train, n_side, n_side, 40.0)
    net = snn.RewardModulatedLatticeNetwork()
    net.add_lattice(rlat)
    net.add_lattice(plain)
    net.add_spike_train_lattice(st)
    net.connect(2, 1, lambda a, b: a == b, lambda a, b: 30.0)
    net.connect_with_reward_modulation(1, 0, lambda a, b: a == b,
                                       lambda a, b: 1.0)
    return net


def both_reward(build, use_pallas, use_kernel):
    """The JAX reward network of ``build()`` and the port's copy."""
    j = build()
    j.use_pallas = use_pallas
    t = reward_network_from(j, "cpu")
    t.use_kernel = use_kernel
    return j, t


def assert_reward_networks_match(t, j, rtol, atol):
    """`assert_networks_match` over the plain lattices, then every reward
    lattice's state, weights and traces, the reward connections' host
    6-tuples and the dopamine; counters equal."""
    assert_networks_match(t, j, rtol, atol)
    for lid, jl in j.reward_modulated_lattices.items():
        tl = t.reward_modulated_lattices[lid]
        for k in ("v", "w", "refractory_count"):
            if k in jl.state:
                np.testing.assert_allclose(
                    tl.state[k].numpy(), np.asarray(jl.state[k]), rtol=rtol,
                    atol=atol, err_msg=f"{k} of reward lattice {lid}")
        for k in ("last_firing_time", "is_spiking"):
            np.testing.assert_array_equal(
                tl.state[k].numpy(), np.asarray(jl.state[k]),
                err_msg=f"{k} of reward lattice {lid}")
        np.testing.assert_allclose(tl.graph.weights.numpy(),
                                   np.asarray(jl.graph.weights), rtol=rtol,
                                   atol=atol, err_msg=f"weights {lid}")
        for k in ("c", "dw"):
            np.testing.assert_allclose(tl.trace[k].numpy(),
                                       np.asarray(jl.trace[k]), rtol=rtol,
                                       atol=atol, err_msg=f"trace {k} {lid}")
        np.testing.assert_array_equal(tl.trace["counter"].numpy(),
                                      np.asarray(jl.trace["counter"]))
        assert tl.internal_clock == jl.internal_clock
        np.testing.assert_allclose(tl.dopamine, jl.dopamine, rtol=rtol,
                                   atol=atol)
    assert set(t.reward_connections) == set(j.reward_connections)
    for key, jc in j.reward_connections.items():
        tc = t.reward_connections[key]
        for a, b in zip(tc[:2], jc[:2]):
            np.testing.assert_array_equal(a, np.asarray(b))
        for a, b, name in zip(tc[2:5], jc[2:5], ("w", "c", "dw")):
            np.testing.assert_allclose(a, np.asarray(b), rtol=rtol,
                                       atol=atol, err_msg=f"{key} {name}")
        np.testing.assert_array_equal(tc[5], np.asarray(jc[5]))
    np.testing.assert_allclose(t.dopamine, j.dopamine, rtol=rtol, atol=atol)

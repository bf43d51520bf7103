"""The port's `RewardModulatedLatticeNetwork` on its plain route
(``use_kernel=False``) against the JAX package's XLA structured reward
runner (``use_pallas=False``), on networks built in the JAX package and
carried over with `convert.reward_network_from`: the reward network of
``tests/test_pallas_reward.py`` (Rate and ALIF forms), the configurations
of ``tests/test_reward_network.py``, two runs in a row, the Agent trait,
Poisson statistics, and the chemical `RewardModulatedLattice`.

Tolerance: v, weights, traces (c, dw), connection weights and dopamine
within rtol 1e-5, atol 1e-4; firing times, spikes and trace counters
equal.  The two packages round a few operations apart (the JAX
structured runner takes ``exp(-dt / tau_d)`` every step, the port once on
the host; XLA folds some divisions), and the dopamine grows to ~1e3 under
a reward of 0.5, so weights are held at the same rtol as v.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.ops.graph import DenseGraph
from spiking_neural_networks_tpu_torch.convert import (reward_lattice_from,
                                                       reward_network_from)
from torch_networks import (assert_reward_networks_match, both_reward,
                            reward_net)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4


def _reward_lattice(seed=0, n_side=3, id=0):
    """`tests/test_reward_network.make_reward_lattice`: a reward lattice
    on a random 50% `DenseGraph`."""
    rng = np.random.default_rng(seed)
    n = n_side * n_side
    lat = snn.RewardModulatedLattice(snn.Izhikevich(), id=id)
    lat.populate(n_side, n_side, gap_conductance=10.0)
    mask = rng.random((n, n)) < 0.5
    np.fill_diagonal(mask, False)
    w = rng.uniform(0.5, 1.5, (n, n)).astype(np.float32)
    lat.graph = DenseGraph(jnp.asarray(np.where(mask, w, 0.0)),
                           jnp.asarray(mask))
    lat._reset_trace()
    lat.apply(lambda s: {**s, "v": jnp.asarray(
        rng.uniform(-65, 25, n), jnp.float32)})
    return lat


def _mixed_net(seed=11, plastic=True):
    """`tests/test_reward_network._mixed_net`: a plastic lattice (0), a
    quiet plain lattice (3), a reward lattice on a `DenseGraph` (1) and a
    Rate train (2); plain connections 2->0, 2->3, 0->3, 3->1 (a plain edge
    into a modulated lattice) and reward connections 0->1 and 2->1."""
    rng = np.random.default_rng(seed)
    lats = []
    for lid in (0, 3):
        lat = snn.Lattice(snn.Izhikevich(), id=lid)
        lat.populate(3, 3, gap_conductance=10.0)
        lat.connect(lambda a, b: a != b)
        lat.apply(lambda s: {**s, "v": jnp.asarray(
            rng.uniform(-65, 25, 9), jnp.float32)})
        lats.append(lat)
    lats[0].do_plasticity = plastic
    st = snn.SpikeTrainLattice(snn.RateSpikeTrain(), id=2)
    st.populate(3, 3, rate=1.5)
    net = snn.RewardModulatedLatticeNetwork()
    for lat in lats + [_reward_lattice(seed + 1, id=1)]:
        net.add_lattice(lat)
    net.add_spike_train_lattice(st)
    for pre, post, w in ((2, 0, 5.0), (2, 3, 8.0), (0, 3, 0.7),
                         (3, 1, 0.9)):
        net.connect(pre, post, lambda a, b: a == b, lambda a, b, w=w: w)
    net.connect_with_reward_modulation(0, 1, lambda a, b: a == b,
                                       lambda a, b: 1.0)
    net.connect_with_reward_modulation(2, 1, lambda a, b: a == b,
                                       lambda a, b: 8.0)
    return net


def _single():
    net = snn.RewardModulatedLatticeNetwork()
    net.add_lattice(_reward_lattice(seed=7))
    return net


def _unmodulated():
    net = reward_net("rate")
    net.reward_modulated_lattices[0].do_modulation = False
    return net


REWARDS = np.where(np.arange(121) % 7 < 4, 0.4, -0.2).astype(np.float32)
NETS = {"rate": (lambda: reward_net("rate"), 0.5, 121),
        "alif": (lambda: reward_net("rate", "alif"), 0.5, 90),
        "dense-single": (_single, REWARDS[:100], 100),
        "mixed": (_mixed_net, REWARDS, 121),
        "plain-edge-into-modulated": (lambda: _mixed_net(plastic=False),
                                      0.5, 121),
        "unmodulated": (_unmodulated, 0.5, 90)}


@pytest.mark.parametrize("name", sorted(NETS))
def test_plain_route_matches_xla_runner(name):
    build, reward, steps = NETS[name]
    j, t = both_reward(build, False, False)
    j.run_lattices_with_reward(jnp.asarray(reward), steps)
    t.run_lattices_with_reward(reward, steps)
    assert t._last_run_fused is False and not j._last_run_fused
    assert_reward_networks_match(t, j, RTOL, ATOL)
    fired = sum(int((l.state["last_firing_time"] >= 0).sum())
                for l in t._neuron_lattices().values())
    assert fired > 0 or name == "dense-single"   # 3x3, v0 below threshold


def test_plain_edge_into_modulated_lattice_gets_stdp():
    """The plain edge 3 -> 1 (post modulated, pre plain) moves every step
    with no plastic lattice, as in the JAX package; the quiet lattice's
    own weights never move."""
    _, t = both_reward(lambda: _mixed_net(plastic=False), False, False)
    w_before = t.connections[(3, 1)][2].copy()
    q_before = t.lattices[3].graph.weights.clone()
    t.run_lattices_with_reward(0.5, 300)
    assert np.abs(t.connections[(3, 1)][2] - w_before).max() > 0
    assert torch.equal(t.lattices[3].graph.weights, q_before)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_two_runs_equal_one_run(use_kernel):
    """Two `run_lattices_with_reward` calls in a row give the one run of
    the same total on either route: the structured plan keeps its device
    copies of the reward connections' weights and traces in step with
    the host mirrors."""
    j, one = both_reward(lambda: reward_net("rate"), False, use_kernel)
    two = reward_network_from(j, "cpu")
    two.use_kernel = use_kernel
    one.run_lattices_with_reward(0.5, 100)
    two.run_lattices_with_reward(0.5, 37)
    two.run_lattices_with_reward(0.5, 63)
    j.run_lattices_with_reward(0.5, 100)
    assert_reward_networks_match(two, j, RTOL, ATOL)
    for key, c in one.reward_connections.items():
        for a, b in zip(c, two.reward_connections[key]):
            np.testing.assert_array_equal(a, b)
    for i, lat in one._neuron_lattices().items():
        other = two._neuron_lattices()[i]
        assert torch.equal(lat.state["v"], other.state["v"])
        assert torch.equal(lat.graph.weights, other.graph.weights)
    assert one.dopamine == two.dopamine


def test_agent_trait():
    """`update_and_apply_reward` is one rewarded step, `update` one step
    without a reward, as in the JAX package."""
    j, t = both_reward(lambda: reward_net("rate"), False, False)
    for net in (j, t):
        for k in range(6):
            net.update_and_apply_reward(0.3 if k % 2 else -0.1)
        net.update()
        net.update()
    assert t.internal_clock == j.internal_clock == 8
    assert_reward_networks_match(t, j, RTOL, ATOL)


def test_run_lattices_keeps_the_dopamine():
    """`run_lattices` steps without a reward: the dopamine stays and
    still modulates."""
    j, t = both_reward(lambda: reward_net("rate"), False, False)
    for net in (j, t):
        net.dopamine = 0.3
        net.run_lattices(40)
    assert t.dopamine == pytest.approx(0.3)
    assert_reward_networks_match(t, j, RTOL, ATOL)


def test_poisson_statistics():
    """Poisson trains draw from each package's own generator; firing
    fractions agree statistically, the dopamine (independent of spikes)
    to rtol 1e-4, as ``tests/test_pallas_reward.py`` holds its kernel."""
    def stats(net):
        net.run_lattices_with_reward(0.2, 400)
        lft = net.lattices[1].state["last_firing_time"]
        st = net.spike_train_lattices[2].state["last_firing_time"]
        return (float((np.asarray(lft) >= 0).mean()),
                float((np.asarray(st) >= 0).mean()), float(net.dopamine))

    j, t = both_reward(lambda: reward_net("poisson", seed=3), False, False)
    fa, sa, da = stats(j)
    fb, sb, db = stats(t)
    assert abs(fa - fb) <= 0.2 and abs(sa - sb) <= 0.2
    assert abs(da - db) <= 1e-4 * max(1.0, abs(da))


def _chemical_lattice():
    """The chemical reward lattice of ``tests/test_pallas_reward.py``
    (`test_fused_fallback_on_unsupported_config`: 6x6 on the ``x != y``
    predicate, AMPA released), with an AMPA receptor (g 25, e 60) and v0
    up to 40 mV, so that neurons fire, release and receive."""
    lat = snn.RewardModulatedLattice(snn.Izhikevich())
    lat.populate(6, 6, gap_conductance=10.0)
    lat.connect(lambda x, y: x != y)
    lat.chemical_synapse = True
    lat.state = lat.model.insert_neurotransmitter(lat.state, "AMPA",
                                                  t_max=1.0)
    lat.state = lat.model.insert_receptor(lat.state, "AMPA", g=25.0, e=60.0)
    v0 = np.random.default_rng(5).uniform(-65, 40, 36)
    lat.apply(lambda s: {**s, "v": jnp.asarray(v0, jnp.float32)})
    return lat


@pytest.mark.parametrize("use_kernel", [None, True, False])
def test_chemical_reward_lattice_matches_xla(use_kernel):
    """Chemical synapses on a `RewardModulatedLattice` take the plain
    route on every setting (the kernel gate refuses them, as the JAX
    gate does) and match the XLA path."""
    j = _chemical_lattice()
    j.use_pallas = False
    t = reward_lattice_from(j, snt.Izhikevich(), "cpu")
    t.use_kernel = use_kernel
    j.run_lattice_with_reward(0.4, 30)
    t.run_lattice_with_reward(0.4, 30)
    assert t._last_run_fused is False
    for k in ("v", "w", "nt$t", "rec$r"):
        np.testing.assert_allclose(t.state[k].numpy(), np.asarray(j.state[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(t.state["last_firing_time"].numpy(),
                                  np.asarray(j.state["last_firing_time"]))
    np.testing.assert_allclose(t.graph.weights.numpy(),
                               np.asarray(j.graph.weights), rtol=RTOL,
                               atol=ATOL)
    assert (np.asarray(j.state["last_firing_time"]) >= 0).any()
    assert float(np.asarray(j.state["rec$r"]).max()) > 0


def test_reward_network_from_carries_everything():
    j = _mixed_net()
    j.run_lattices_with_reward(0.5, 20)
    j.reward_modulator.params["tau_d"] = 3.0
    t = reward_network_from(j, "cpu")
    assert isinstance(t, snt.RewardModulatedLatticeNetwork)
    assert sorted(t.lattices) == [0, 3]
    assert list(t.reward_modulated_lattices) == [1]
    assert t.internal_clock == j.internal_clock == 20
    assert t.dopamine == pytest.approx(j.dopamine)
    assert t.reward_modulator.params["tau_d"] == 3.0
    r = t.reward_modulated_lattices[1]
    assert r.do_modulation and r.dopamine == pytest.approx(j.dopamine)
    for k in ("c", "dw", "counter"):
        np.testing.assert_array_equal(
            r.trace[k].numpy(),
            np.asarray(j.reward_modulated_lattices[1].trace[k]))
    for key, jc in j.reward_connections.items():
        for a, b in zip(t.reward_connections[key], jc):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert_reward_networks_match(t, j, 0.0, 0.0)


def test_construction_errors():
    net = snt.RewardModulatedLatticeNetwork("cpu")
    r = snt.RewardModulatedLattice(snt.Izhikevich(), id=0, device="cpu")
    r.populate(3, 3)
    net.add_lattice(r)
    with pytest.raises(snt.errors.LatticeNetworkError):
        net.add_lattice(snt.Lattice(snt.Izhikevich(), id=0, device="cpu"))
    other = snt.Lattice(snt.LeakyIntegrateAndFire(), id=1, device="cpu")
    other.populate(3, 3)
    with pytest.raises(snt.errors.LatticeNetworkError):
        net.add_lattice(other)
    with pytest.raises(KeyError):
        net.connect_with_reward_modulation(0, 5, lambda a, b: a == b)
    with pytest.raises(KeyError):
        net.connect_with_reward_modulation(5, 0, lambda a, b: a == b)
    assert net.get_reward_modulated_lattice(0) is r


def test_per_edge_surface_reaches_reward_edges():
    """`lookup_weight`, `edit_weight` and `get_incoming_connections` read
    and edit reward lattices' intra edges and reward connections' edges
    (in place), as in the JAX package; the edited network still runs as
    the JAX one does."""
    j, t = both_reward(_mixed_net, False, False)
    queries = [((0, (1, 1)), (1, (1, 1))), ((2, (0, 2)), (1, (0, 2))),
               ((3, (2, 0)), (1, (2, 0))), ((1, (0, 0)), (1, (0, 1))),
               ((0, (0, 0)), (1, (2, 2)))]
    for pre, post in queries:
        assert t.lookup_weight(pre, post) == j.lookup_weight(pre, post)
    for pos in ((1, (1, 1)), (0, (2, 2))):
        assert t.get_incoming_connections(pos) == \
            j.get_incoming_connections(pos)
    for net in (j, t):
        net.edit_weight((0, (1, 1)), (1, (1, 1)), 2.5)
        net.edit_weight((2, (0, 2)), (1, (0, 2)), None)
        net.edit_weight((0, (2, 2)), (1, (0, 0)), 0.25)
    assert t.lookup_weight((0, (1, 1)), (1, (1, 1))) == 2.5
    assert t.lookup_weight((2, (0, 2)), (1, (0, 2))) is None
    for key, jc in j.reward_connections.items():
        for a, b in zip(t.reward_connections[key], jc):
            np.testing.assert_array_equal(a, np.asarray(b))
    for key, jc in j.connections.items():
        for a, b in zip(t.connections[key], jc):
            np.testing.assert_array_equal(a, np.asarray(b))
    j.run_lattices_with_reward(0.5, 40)
    t.run_lattices_with_reward(0.5, 40)
    assert_reward_networks_match(t, j, RTOL, ATOL)

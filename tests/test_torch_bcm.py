"""The port's BCM rule (`core/plasticity.BCM`) against the JAX package's:
``apply_visits`` on random inputs, and BCM on the plain route of a single
`Lattice`, of the structured network runner and of the flat COO runner
(the upstream BCM example, ``examples/bcm.py``: two BCM Poisson trains
into one `BCMIzhikevich` neuron, with a connecting-graph history), and on
a reward network's plain lattices through both reward runners (over 150
steps: v within rtol 2e-5, atol 2e-4, weights within rtol 2e-4, atol
2e-4).  The trains' chances are 0 or 1, so that their draws do not
matter.

Tolerance: ``apply_visits`` within rtol 1e-5, atol 1e-5; after a run,
weights, v and activities within rtol 1e-5, atol 1e-4; firing times,
spikes and counts equal.  The example's windows are cut from 500 to 0.5
(5 steps), so that the activities, and with them the BCM deltas, move
within the run.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.core import plasticity as jpl
from spiking_neural_networks_tpu_torch.convert import (lattice_from,
                                                       network_from)
from spiking_neural_networks_tpu_torch.core import plasticity as tpl
from spiking_neural_networks_tpu_torch.core.plasticity import rule_tensors
from torch_networks import assert_networks_match

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5
PARAMS = dict(decay=0.1, average_scalar=0.1, dt=0.1)


@pytest.mark.parametrize("shape", [(1000,), (12, 40)])
def test_apply_visits_matches_jax(shape):
    rng = np.random.default_rng(len(shape))

    def f(lo, hi):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    w = f(-2, 2)
    node = {"current_activity": f(0, 5), "average_activity": f(0, 5)}
    node2 = {"current_activity": f(0, 5), "average_activity": f(0, 5)}
    count = rng.integers(0, 3, shape).astype(np.float32)
    jp = {k: jnp.float32(v) for k, v in PARAMS.items()}
    tp = rule_tensors(PARAMS, "cpu")
    want = jpl.BCM.apply_visits(jnp.asarray(w),
                                {k: jnp.asarray(v) for k, v in node.items()},
                                {k: jnp.asarray(v) for k, v in node2.items()},
                                jp, jnp.asarray(count))
    got = tpl.BCM.apply_visits(torch.from_numpy(w),
                               {k: torch.from_numpy(v)
                                for k, v in node.items()},
                               {k: torch.from_numpy(v)
                                for k, v in node2.items()},
                               tp, torch.from_numpy(count))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # two visits decay the once-updated weight: not twice one visit
    two = torch.full(shape, 2.0)
    one = torch.ones(shape)
    t = {k: torch.from_numpy(v) for k, v in node.items()}
    w0 = torch.from_numpy(w)
    d1 = tpl.BCM.apply_visits(w0, t, t, tp, one) - w0
    d2 = tpl.BCM.apply_visits(w0, t, t, tp, two) - w0
    assert not torch.allclose(d2, 2 * d1)
    assert tpl.BCM.NODE_KEYS == jpl.BCM.NODE_KEYS
    assert tpl.BCM().params == jpl.BCM().params


def _bcm_lattice(rows=10, cols=10):
    """A JAX `BCMIzhikevich` lattice with BCM plasticity on a radius-2
    stencil, v0 across the threshold, windows of 5 steps."""
    lat = snn.Lattice(snn.BCMIzhikevich())
    lat.populate(rows, cols, gap_conductance=5.0, firing_rate_window=0.5)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=3)
    v0 = np.random.default_rng(8).uniform(-65, 35, rows * cols)
    lat.apply(lambda s: {**s, "v": jnp.asarray(v0, jnp.float32)})
    lat.plasticity = snn.BCM()
    lat.do_plasticity = True
    return lat


def test_bcm_lattice_plain_route_matches_jax():
    j = _bcm_lattice()
    t = lattice_from(j, device="cpu")
    assert type(t.plasticity) is tpl.BCM and t.do_plasticity
    t.use_kernel = True            # no kernel takes BCM: the plain route
    j.run_lattice(60)
    t.run_lattice(60)
    assert t._last_run_fused is False
    np.testing.assert_allclose(t.graph.weights.numpy(),
                               np.asarray(j.graph.weights), rtol=RTOL,
                               atol=1e-4)
    for k in ("v", "w", "current_activity", "average_activity"):
        np.testing.assert_allclose(t.state[k].numpy(), np.asarray(j.state[k]),
                                   rtol=RTOL, atol=1e-4, err_msg=k)
    for k in ("last_firing_time", "num_spikes"):
        np.testing.assert_array_equal(t.state[k].numpy(),
                                      np.asarray(j.state[k]))
    assert int((t.state["last_firing_time"] >= 0).sum()) > 0
    w0 = lattice_from(_bcm_lattice(), device="cpu").graph.weights
    assert not torch.equal(t.graph.weights, w0)


def bcm_example(n_trains=2, firing=(1.0, 0.0), seed=0):
    """``examples/bcm.py``'s network in the JAX package with the trains'
    chances at ``firing`` (0 or 1): BCM Poisson trains into one
    `BCMIzhikevich` neuron (c_m 50, gap 5) with Gaussian weights, the
    connecting-graph history on (the flat runner); windows of 5 steps."""
    rng = np.random.default_rng(seed)
    st = snn.SpikeTrainLattice(snn.BCMPoissonSpikeTrain(), id=0)
    st.populate(n_trains, 1)
    st.apply(lambda s: {**s, "chance_of_firing": jnp.asarray(
        firing, jnp.float32), "firing_rate_window": jnp.full(
            (n_trains,), 0.5, jnp.float32)})
    post = snn.Lattice(snn.BCMIzhikevich(), id=1)
    post.populate(1, 1, c_m=50.0, gap_conductance=5.0,
                  firing_rate_window=0.5)
    post.plasticity = snn.BCM()
    post.do_plasticity = True
    net = snn.LatticeNetwork.generate_network([post], [st])
    w0 = np.clip(rng.normal(1.5, 0.1, (n_trains, 1)), 1.0, 2.0)
    net.connect(0, 1, lambda x, y: True, lambda x, y: float(w0[x[0], 0]))
    net.update_connecting_graph_history = True
    return net


def test_bcm_example_flat_runner_matches_jax():
    j = bcm_example()
    t = network_from(j, "cpu")
    assert t.update_connecting_graph_history
    j.run_lattices(500)
    t.run_lattices(500)
    assert t._last_run_fused is False
    jh = np.asarray(j.connecting_graph_history)
    th = np.asarray(t.connecting_graph_history)
    assert th.shape == jh.shape
    np.testing.assert_allclose(th, jh, rtol=1e-5, atol=1e-4)
    assert not np.allclose(th[-1], th[0])        # BCM moved the weights
    assert_networks_match(t, j, 1e-5, 1e-4)
    post = t.lattices[1].state
    assert int(post["num_spikes"][0]) > 0


def test_bcm_structured_runner_matches_jax():
    """A BCM lattice (plastic, 5 x 5) fed by a 5 x 5 BCM train one to one,
    on the structured runner's plain route."""
    st = snn.SpikeTrainLattice(snn.BCMPoissonSpikeTrain(), id=0)
    st.populate(5, 5)
    chance = np.tile([1.0, 0.0], 13)[:25].astype(np.float32)
    st.apply(lambda s: {**s, "chance_of_firing": jnp.asarray(chance),
                        "firing_rate_window": jnp.full((25,), 0.5,
                                                       jnp.float32)})
    lat = _bcm_lattice(5, 5)
    lat.id = 1
    net = snn.LatticeNetwork.generate_network([lat], [st])
    net.connect(0, 1, lambda x, y: x == y, lambda x, y: 1.2)
    assert net.structured
    t = network_from(net, "cpu")
    net.run_lattices(120)
    t.run_lattices(120)
    assert t._last_run_fused is False
    assert_networks_match(t, net, 1e-5, 1e-4)
    for k in ("current_activity", "average_activity"):
        np.testing.assert_allclose(t.lattices[1].state[k].numpy(),
                                   np.asarray(net.lattices[1].state[k]),
                                   rtol=1e-5, atol=1e-4)


def test_bcm_on_a_poisson_train_reads_zero_activity():
    """A Poisson train has no BCM activity fields: the structured runner
    reads zeros there, as the JAX package does."""
    st = snn.SpikeTrainLattice(snn.PoissonSpikeTrain(), id=0)
    st.populate(3, 3)
    st.apply(lambda s: {**s, "chance_of_firing": jnp.ones(9, jnp.float32)})
    lat = _bcm_lattice(3, 3)
    lat.id = 1
    net = snn.LatticeNetwork.generate_network([lat], [st])
    net.connect(0, 1, lambda x, y: x == y, lambda x, y: 1.0)
    t = network_from(net, "cpu")
    net.run_lattices(30)
    t.run_lattices(30)
    assert_networks_match(t, net, 1e-5, 1e-4)


def bcm_reward_net(structured, train="bcm", n=5):
    """JAX ``tests/test_fuzz_runners.py``'s BCM pair (two plastic
    `BCMIzhikevich` lattices with BCM, 1 -> 2 one to one) in a
    `RewardModulatedLatticeNetwork`, with a `BCMIzhikevich` reward lattice
    (0) fed by lattice 2 through a reward connection, and a train (3) into
    lattice 1: a BCM Poisson train (``train="bcm"``) or a plain Poisson
    train, whose missing activities read as zeros.  The trains' chances
    are 0 or 1, so that their draws do not matter; windows of 5 steps."""
    rng = np.random.default_rng(77)
    net = snn.RewardModulatedLatticeNetwork()
    rlat = snn.RewardModulatedLattice(snn.BCMIzhikevich(), id=0)
    rlat.populate(n, n, gap_conductance=10.0, firing_rate_window=0.5)
    rlat.connect_stencil(radius=1.5, keep_prob=0.9, seed=69)
    v0 = rng.uniform(-65.0, 30.0, n * n)
    rlat.apply(lambda s: {**s, "v": jnp.asarray(v0, jnp.float32)})
    net.add_lattice(rlat)
    for k in (1, 2):
        lat = snn.Lattice(snn.BCMIzhikevich(), id=k)
        lat.populate(n, n, gap_conductance=10.0, firing_rate_window=0.5)
        lat.connect_stencil(radius=1.5, keep_prob=0.9, seed=70 + k)
        v0 = rng.uniform(-65.0, 30.0, n * n)
        v0[rng.permutation(n * n)[:4]] = 40.0
        lat.apply(lambda s, v0=v0: {**s, "v": jnp.asarray(v0, jnp.float32)})
        lat.do_plasticity = True
        lat.plasticity = snn.BCM()
        net.add_lattice(lat)
    model = snn.BCMPoissonSpikeTrain() if train == "bcm" \
        else snn.PoissonSpikeTrain()
    st = snn.SpikeTrainLattice(model, id=3)
    st.populate(n, n)
    chance = np.tile([1.0, 0.0], n * n)[:n * n].astype(np.float32)
    over = {"chance_of_firing": jnp.asarray(chance)}
    if train == "bcm":
        over["firing_rate_window"] = jnp.full((n * n,), 0.5, jnp.float32)
    st.apply(lambda s: {**s, **over})
    net.add_spike_train_lattice(st)
    net.connect(1, 2, lambda a, b: a == b, lambda a, b: 2.0)
    net.connect(3, 1, lambda a, b: a == b, lambda a, b: 3.0)
    net.connect_with_reward_modulation(2, 0, lambda a, b: a == b,
                                       lambda a, b: 1.0)
    net.structured = structured
    return net


@pytest.mark.parametrize("train", ["bcm", "poisson"])
@pytest.mark.parametrize("structured", [True, False])
def test_bcm_reward_network_matches_jax(structured, train):
    """BCM on a reward network's plain lattices through the structured
    runner and the flat COO runner, against the JAX package's over 150
    steps at reward 0.5: v within rtol 2e-5, atol 2e-4, weights, traces,
    reward connections and dopamine within rtol 2e-4, atol 2e-4, firing
    times equal, and the BCM weights moved."""
    from spiking_neural_networks_tpu_torch.convert import reward_network_from
    from torch_networks import assert_reward_networks_match
    j = bcm_reward_net(structured, train)
    t = reward_network_from(j, "cpu")
    w0 = {k: t.lattices[k].graph.weights.clone() for k in (1, 2)}
    c0 = t.connections[(1, 2)][2].copy()
    j.run_lattices_with_reward(0.5, 150)
    t.run_lattices_with_reward(0.5, 150)
    assert t._last_run_fused is False
    for k in (0, 1, 2):
        tl, jl = t._neuron_lattices()[k], j._neuron_lattices()[k]
        np.testing.assert_allclose(tl.state["v"].numpy(),
                                   np.asarray(jl.state["v"]), rtol=2e-5,
                                   atol=2e-4, err_msg=f"v of lattice {k}")
    assert_reward_networks_match(t, j, 2e-4, 2e-4)
    for k in (1, 2):
        for f in ("current_activity", "average_activity"):
            np.testing.assert_allclose(
                t.lattices[k].state[f].numpy(),
                np.asarray(j.lattices[k].state[f]), rtol=2e-4, atol=2e-4)
    moved = [not torch.equal(t.lattices[k].graph.weights, w0[k])
             for k in (1, 2)]
    assert all(moved), "vacuous: BCM left an intra-lattice weight plane"
    assert not np.array_equal(t.connections[(1, 2)][2], c0)


def test_bcm_reward_network_gates_stay_plain():
    """The reward arm takes STDP only: with BCM on the plastic lattice of
    a kernel-eligible reward network its gate declines, and the BCM
    network run with ``use_kernel = True`` takes the plain route."""
    from spiking_neural_networks_tpu_torch.convert import reward_network_from
    from spiking_neural_networks_tpu_torch.core.reward_structured import (
        resolve_reward_plan)
    from spiking_neural_networks_tpu_torch.ops import network_kernels as nk
    from torch_networks import reward_net
    t = reward_network_from(reward_net(), "cpu")
    kinds = ("mod", "plastic")
    plan = resolve_reward_plan(t)
    assert nk.reward_network_spec(t, plan, kinds, True, True) is not None
    t.lattices[1].plasticity = snt.BCM()
    assert nk.reward_network_spec(t, plan, kinds, True, True) is None
    b = reward_network_from(bcm_reward_net(True), "cpu")
    b.use_kernel = True
    b.run_lattices_with_reward(0.5, 3)
    assert b._last_run_fused is False

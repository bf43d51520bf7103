"""The port's flat COO network runner (`LatticeNetwork._compile`,
`_run_chunk`, `core.network.flat_steps`) against the JAX package's flat
runner (``structured = False``), on networks built in the JAX package and
carried over with `convert.network_from`: electrical, chemical and STDP
networks with ``dense_gather`` on and off, a `LatticeNetwork` subclass,
the connecting-graph history, per-lattice graph and grid histories; and
the reward network's flat COO path against the JAX one and against the
port's structured reward runner.

Tolerance: v, weights, traces and dopamine within rtol 1e-5, atol 1e-4;
firing times, spikes and counters equal.  The flat runner sums its
gathers with ``index_add_`` (or dense products), in another order than
XLA's ``segment_sum``; a run of 60-121 steps stays within the tolerance.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.core.history import HISTORY_KINDS
from spiking_neural_networks_tpu_torch.convert import (network_from,
                                                       reward_network_from)
from test_torch_reward_network import _mixed_net as reward_mixed_net
from torch_networks import (assert_networks_match,
                            assert_reward_networks_match, chem_net,
                            mixed_net, plain_net, reward_net)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
NETS = {"electrical": lambda: plain_net("izhikevich", plastic_a=False,
                                        plastic_b=False),
        "stdp": lambda: plain_net("izhikevich"),
        "alif": lambda: plain_net("alif"),
        "mixed": mixed_net,
        "chemical": lambda: chem_net(family="dopaglugaba", dopamine=True),
        "chemical-stdp": lambda: chem_net(plastic=True)}


def _flat_pair(build, dense_gather):
    j = build()
    j.structured = False
    j.dense_gather = dense_gather
    t = network_from(j, "cpu")
    t.dense_gather = dense_gather
    return j, t


@pytest.mark.parametrize("dense_gather", [True, False])
@pytest.mark.parametrize("name", sorted(NETS))
def test_flat_runner_matches_jax_flat_runner(name, dense_gather):
    j, t = _flat_pair(NETS[name], dense_gather)
    assert not t.structured
    j.run_lattices(60)
    t.run_lattices(60)
    assert t._last_run_fused is False
    assert_networks_match(t, j, RTOL, ATOL)
    assert sum(int((l.state["last_firing_time"] >= 0).sum())
               for l in t.lattices.values()) > 0


def test_subclass_takes_the_flat_runner():
    """A `LatticeNetwork` subclass runs the flat COO runner, as in the
    JAX package, and matches its flat runner."""
    class Sub(snt.LatticeNetwork):
        pass

    j = plain_net("izhikevich")
    j.structured = False
    t = network_from(j, "cpu", net=Sub("cpu"))
    assert type(t) is Sub and t.structured is False
    t.structured = True            # a subclass is flat all the same
    j.run_lattices(80)
    t.run_lattices(80)
    assert_networks_match(t, j, RTOL, ATOL)
    t.run_lattices(5)
    assert t.internal_clock == 88 and t._last_run_fused is False


def test_connecting_graph_history():
    """``update_connecting_graph_history`` records every step's flat edge
    weights (intra and connecting edges, plastic ones moving), in chunks
    as in the JAX package."""
    def build():
        net = plain_net("izhikevich")
        net.update_connecting_graph_history = True
        net.history_chunk = 17
        return net

    j = build()
    t = network_from(j, "cpu")
    assert t.update_connecting_graph_history and t.history_chunk == 17
    j.run_lattices(50)
    t.run_lattices(50)
    assert_networks_match(t, j, RTOL, ATOL)
    hj = np.stack(j.connecting_graph_history)
    ht = np.stack(t.connecting_graph_history)
    assert ht.shape == hj.shape == (50, hj.shape[1])
    np.testing.assert_allclose(ht, hj, rtol=RTOL, atol=ATOL)
    assert np.abs(ht[-1] - ht[0]).max() > 0


def test_graph_and_grid_histories():
    """Per-lattice graph histories in each graph's layout (a stencil's
    planes), an EEG grid history and a train's grid history."""
    def build():
        net = mixed_net(hist=HISTORY_KINDS["eeg"](reference_voltage=0.1))
        net.structured = False
        net.lattices[0].update_graph_history = True
        net.spike_train_lattices[2].update_grid_history = True
        return net

    j = build()
    t = network_from(j, "cpu")
    j.run_lattices(40)
    t.run_lattices(40)
    assert_networks_match(t, j, RTOL, ATOL)
    for hj, ht in ((j.lattices[0].graph_history, t.lattices[0].graph_history),
                   (j.lattices[0].grid_history.history,
                    t.lattices[0].grid_history.history),
                   (j.spike_train_lattices[2].grid_history.history,
                    t.spike_train_lattices[2].grid_history.history)):
        assert len(ht) == len(hj) == 40
        np.testing.assert_allclose(np.stack([np.asarray(x) for x in ht]),
                                   np.stack([np.asarray(x) for x in hj]),
                                   rtol=RTOL, atol=ATOL)


def test_reward_flat_path_matches_jax():
    for build in (lambda: reward_net("rate"), reward_mixed_net):
        j = build()
        j.structured = False
        t = reward_network_from(j, "cpu")
        rewards = np.where(np.arange(90) % 7 < 4, 0.4, -0.2).astype(
            np.float32)
        j.run_lattices_with_reward(jnp.asarray(rewards), 90)
        t.run_lattices_with_reward(rewards, 90)
        assert t._last_run_fused is False
        assert_reward_networks_match(t, j, RTOL, ATOL)


def test_reward_flat_path_matches_structured_runner():
    """As ``tests/test_reward_network.py`` holds the JAX runners: the flat
    COO path and the structured runner compute the same states, weights,
    traces and dopamine (the flat path as the equivalence oracle)."""
    rewards = np.where(np.arange(120) % 7 < 4, 0.4, -0.2).astype(np.float32)
    j = reward_mixed_net()
    flat = reward_network_from(j, "cpu")
    flat.structured = False
    stru = reward_network_from(j, "cpu")
    flat.run_lattices_with_reward(rewards, 120)
    stru.run_lattices_with_reward(rewards, 120)
    for i, lat in stru._neuron_lattices().items():
        other = flat._neuron_lattices()[i]
        np.testing.assert_allclose(lat.state["v"].numpy(),
                                   other.state["v"].numpy(), rtol=1e-5,
                                   atol=1e-4, err_msg=f"v {i}")
        np.testing.assert_allclose(lat.graph.weights.numpy(),
                                   other.graph.weights.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=f"weights {i}")
    r_s = stru.reward_modulated_lattices[1]
    r_f = flat.reward_modulated_lattices[1]
    for k in ("c", "dw"):
        np.testing.assert_allclose(r_s.trace[k].numpy(),
                                   r_f.trace[k].numpy(), rtol=1e-4, atol=1e-5)
    assert torch.equal(r_s.trace["counter"], r_f.trace["counter"])
    assert stru.dopamine == pytest.approx(flat.dopamine, rel=1e-5)
    for key in flat.connections:
        np.testing.assert_allclose(stru.connections[key][2],
                                   flat.connections[key][2], rtol=1e-5,
                                   atol=1e-4)
    for key in flat.reward_connections:
        for a, b in zip(stru.reward_connections[key][2:],
                        flat.reward_connections[key][2:]):
            np.testing.assert_allclose(np.asarray(a, np.float32),
                                       np.asarray(b, np.float32),
                                       rtol=1e-4, atol=1e-4)


def test_reward_connecting_graph_history():
    """A reward network with a connecting-graph history falls back to the
    flat COO path and records every step's flat weights, reward edges
    appended."""
    j = reward_mixed_net()
    j.update_connecting_graph_history = True
    t = reward_network_from(j, "cpu")
    j.run_lattices_with_reward(0.4, 30)
    t.run_lattices_with_reward(0.4, 30)
    assert len(t.connecting_graph_history) == 30
    np.testing.assert_allclose(np.stack(t.connecting_graph_history),
                               np.stack(j.connecting_graph_history),
                               rtol=RTOL, atol=ATOL)
    assert_reward_networks_match(t, j, RTOL, ATOL)


def test_network_without_lattices_is_refused():
    net = snt.LatticeNetwork("cpu")
    st = snt.SpikeTrainLattice(snt.RateSpikeTrain(), id=2, device="cpu")
    st.populate(3, 3, rate=1.5)
    net.add_spike_train_lattice(st)
    with pytest.raises(snt.errors.LatticeNetworkError, match="lattice"):
        net.run_lattices(3)

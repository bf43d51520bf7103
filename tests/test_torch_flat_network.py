"""The flat-mode slice as a whole: the Bayesian-inference network of
``tests/test_pallas_chem.py`` (`_bayesian_net`: a 7x7 `DopaIzhikevich`
lattice with Hopfield-dense intra weights and a grid history, a 3x3
inhibitory pool, dense blocks both ways, two Poisson cue lattices at rate
0; chemical synapses only), built through the JAX package's lixirnet
surface and carried into the port with `convert.network_from`.

The port's plain route against the JAX XLA structured runner, and its
kernel route on the CPU (the twin) against the JAX kernel
(``_fused_chunk`` in interpret mode): state and history at rtol 1e-5, atol
1e-4 with firing times and spikes equal, the tolerance of the JAX package's
own test of that network.
"""

import numpy as np
import pytest
import torch

from spiking_neural_networks_tpu_torch.convert import network_from
from spiking_neural_networks_tpu_torch.core.structured import (
    resolve_structured_plan)
from spiking_neural_networks_tpu_torch.ops import graph as tg
from spiking_neural_networks_tpu_torch.ops import network_kernels as nk
from test_pallas_chem import DOPA_KEYS, _bayesian_net
from test_torch_chem_network import (RTOL, ATOL, assert_chem_networks_match)

torch.set_num_threads(1)

STEPS = 121                     # seven K = 16 calls and a remainder of 9


def bayes_pair(use_pallas, use_kernel):
    j = _bayesian_net()._inner
    j.use_pallas = use_pallas
    t = network_from(j, "cpu")
    t.use_kernel = use_kernel
    return j, t


def test_network_from_carries_the_bayesian_network():
    j, t = bayes_pair(False, False)
    assert isinstance(t.lattices[1].graph, tg.DenseGraph)
    assert t.lattices[1].graph.weights.shape == (49, 49)
    assert isinstance(t.lattices[0].graph, tg.SparseGraph)
    np.testing.assert_array_equal(t.lattices[1].graph.weights.numpy(),
                                  np.asarray(j.lattices[1].graph.weights))
    np.testing.assert_array_equal(t.lattices[1].graph.mask.numpy(),
                                  np.asarray(j.lattices[1].graph.mask))
    assert type(t.lattices[1].model).__name__ == "DopaIzhikevich"
    assert t.lattices[1].update_grid_history
    assert (t.chemical_synapse, t.electrical_synapse) == (True, False)
    kinds = {c["key"]: c["op"].kind
             for c in resolve_structured_plan(t)["conns"]}
    assert kinds == {(0, 1): "dense", (1, 0): "dense", (2, 1): "one2one",
                     (3, 1): "one2one"}
    for lid in (0, 1):
        assert set(t.lattices[lid].state) == set(j.lattices[lid].state)


@pytest.mark.parametrize("route", ["plain", "twin"])
def test_bayesian_network_matches_jax(route):
    """121 steps: the plain route against the XLA structured runner, the
    twin against the TPU kernel in interpret mode."""
    kernel = route == "twin"
    j, t = bayes_pair(kernel, kernel)
    j.run_lattices(STEPS)
    t.run_lattices(STEPS)
    assert bool(j._last_run_fused) is kernel
    assert t._last_run_fused == (("flat-chemical", True) if kernel else False)
    assert set(DOPA_KEYS) <= set(t.lattices[1].state)
    assert_chem_networks_match(t, j)
    hj = np.stack([np.asarray(x) for x in j.lattices[1].grid_history.history])
    ht = np.stack(t.lattices[1].grid_history.history)
    assert ht.shape == hj.shape == (STEPS, 7, 7)
    np.testing.assert_allclose(ht, hj, rtol=RTOL, atol=ATOL)
    # the cascade: the seeded spikes release transmitter and the inhibitory
    # pool's receptors open through the dense block
    assert (t.lattices[1].state["last_firing_time"] >= 0).any()
    assert t.lattices[1].state["nt$t"].max() > 0.0
    assert t.lattices[0].state["rec$r"].max() > 0.0


def test_twin_and_plain_routes_agree():
    _, a = bayes_pair(False, False)
    _, b = bayes_pair(False, True)
    a.run_lattices(STEPS)
    b.run_lattices(STEPS)
    for lid in (0, 1):
        for k in ("v", "w") + DOPA_KEYS:
            np.testing.assert_allclose(b.lattices[lid].state[k].numpy(),
                                       a.lattices[lid].state[k].numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        assert torch.equal(a.lattices[lid].state["last_firing_time"],
                           b.lattices[lid].state["last_firing_time"])


def test_bayesian_spec():
    _, t = bayes_pair(False, True)
    plan = resolve_structured_plan(t)
    spec = nk.plain_network_spec(t, plan, False, (True, True))
    assert spec.chem == ("dopaglugaba", "bounded", "bounded")
    assert not spec.electrical
    assert [(ls.graph, ls.shape, ls.emit) for ls in spec.lattices] == [
        ("none", (1, 9), False), ("dense", (1, 49), True)]
    assert [(ts.kind, ts.shape, ts.nt) for ts in spec.trains] == [
        ("poisson", (1, 49), "bounded")] * 2
    assert sum(cs.post == 1 for cs in spec.conns) == 3 <= nk.MAX_IN


def test_chunked_run_equals_one_run():
    """Two runs of 60 and 61 steps leave the state of one run of 121 (the
    cues fire at rate 0, so no draw parts them)."""
    _, a = bayes_pair(False, True)
    _, b = bayes_pair(False, True)
    a.run_lattices(STEPS)
    b.run_lattices(60)
    b.run_lattices(61)
    for lid in (0, 1):
        for k, x in a.lattices[lid].state.items():
            assert torch.equal(x, b.lattices[lid].state[k]), k
    assert len(b.lattices[1].grid_history.history) == STEPS


def test_chip_smoke_builds_the_same_network():
    """`chip_smoke.bayes_net`, which builds the Bayesian network through
    the port's own entry points (the card has no JAX), gives the network
    that `_bayesian_net` gives through the JAX lixirnet surface: the same
    states, graphs and connections."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    import spiking_neural_networks_tpu_torch as snt
    _, t = bayes_pair(False, False)
    s = chip_smoke.bayes_net(snt, (7, 7), (3, 3), device="cpu",
                             hertz=(0.0, 0.0))
    for group in ("lattices", "spike_train_lattices"):
        mine, ref = getattr(s, group), getattr(t, group)
        assert sorted(mine) == sorted(ref)
        for i in ref:
            assert set(mine[i].state) == set(ref[i].state)
            for k, x in ref[i].state.items():
                assert mine[i].state[k].dtype == x.dtype, (i, k)
                assert torch.equal(mine[i].state[k], x), (group, i, k)
    for i, lat in t.lattices.items():
        assert type(s.lattices[i].graph) is type(lat.graph)
        assert torch.equal(s.lattices[i].graph.weights, lat.graph.weights)
        assert s.lattices[i].update_grid_history == lat.update_grid_history
    assert sorted(s.connections) == sorted(t.connections)
    for key, (src, dst, w) in t.connections.items():
        for a, b in zip(s.connections[key], (src, dst, w)):
            np.testing.assert_array_equal(a, b)
    assert (s.electrical_synapse, s.chemical_synapse) == (False, True)

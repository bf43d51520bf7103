"""The slice as a whole: the PyTorch `Lattice` against the JAX `Lattice` on
the CPU, from the same v0 and graph seed."""

import numpy as np
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.core.history import (
    AverageVoltageHistory, EEGHistory, SpikeHistory)
from spiking_neural_networks_tpu_torch.core import history as th
from spiking_neural_networks_tpu_torch.convert import (
    state_from_numpy, stencil_graph_from_numpy)
from spiking_neural_networks_tpu_torch.ops import stencil_kernels
from reference_impl import RefIzhikevich

torch.set_num_threads(1)

V0 = np.random.default_rng(8).uniform(-65, 30, 256).astype(np.float32)


def jax_lattice(rows=16, cols=16, v0=V0, use_pallas=False, seed=4):
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(rows, cols, gap_conductance=10.0, v=v0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=seed)
    lat.use_pallas = use_pallas
    return lat


def torch_lattice(rows=16, cols=16, v0=V0, use_kernel=False, seed=4):
    lat = snt.Lattice(snt.Izhikevich(), device="cpu")
    lat.populate(rows, cols, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=seed)
    lat.apply(lambda s: {**s, "v": torch.as_tensor(v0, device=lat.device)})
    lat.use_kernel = use_kernel
    return lat


def test_plain_route_matches_jax_xla_with_grid_history():
    """150 steps, state and graph carried across with `convert`.  Both run
    the XLA association, but XLA picks the order of the 12-term offset sum
    at this size: rtol 1e-6, atol 1e-5 with lft equal, the JAX package's
    fused-vs-XLA tolerance (tests/test_lattice.py)."""
    j = jax_lattice()
    j.update_grid_history = True
    t = snt.Lattice(snt.Izhikevich(), device="cpu")
    t.populate(16, 16)
    t.state = state_from_numpy({k: np.asarray(v) for k, v in j.state.items()},
                               "cpu")
    g = j.graph
    t.set_graph(stencil_graph_from_numpy(g.offsets, np.asarray(g.weights),
                                         np.asarray(g.mask),
                                         np.asarray(g.in_deg), "cpu"))
    t.use_kernel = False
    t.update_grid_history = True
    t.history_chunk = 64                    # three chunks: 64 + 64 + 22
    j.run_lattice(150)
    t.run_lattice(150)
    assert t._last_run_fused is False and t.internal_clock == 150
    hj = np.stack(j.grid_history.history)
    ht = np.stack(t.grid_history.history)
    assert ht.shape == hj.shape == (150, 16, 16)
    np.testing.assert_allclose(ht, hj, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(t.field("last_firing_time"),
                                  j.field("last_firing_time"))
    np.testing.assert_array_equal(t.field("is_spiking"), j.field("is_spiking"))
    assert (t.field("last_firing_time") >= 0).any()


def test_kernel_route_builds_same_graph_and_state_as_jax():
    j, t = jax_lattice(), torch_lattice()
    for name in ("weights", "mask", "in_deg"):
        np.testing.assert_array_equal(getattr(t.graph, name).numpy(),
                                      np.asarray(getattr(j.graph, name)))
    assert set(t.state) == set(j.state)
    for k in j.state:
        np.testing.assert_array_equal(t.state[k].numpy(),
                                      np.asarray(j.state[k]), err_msg=k)


@pytest.mark.parametrize("hist_cls,thist_cls", [
    (EEGHistory, th.EEGHistory), (SpikeHistory, th.SpikeHistory),
    (AverageVoltageHistory, th.AverageVoltageHistory)])
def test_kernel_route_histories_match_jax_pallas(hist_cls, thist_cls):
    """37 steps = 2 launches of K=16 + a remainder of 5, through the twin,
    against the JAX multi-step kernel in interpret mode: the same fused
    association, so rtol 1e-6, atol 1e-5 (the readouts' sums over 256
    neurons are ordered differently)."""
    j = jax_lattice(use_pallas=True)
    j.grid_history = hist_cls()
    j.update_grid_history = True
    t = torch_lattice(use_kernel=True)
    t.grid_history = thist_cls()
    t.update_grid_history = True
    j.run_lattice(37)
    t.run_lattice(37)
    assert t._last_run_fused == ("kernel", True)
    hj = np.asarray(j.grid_history.history)
    ht = np.asarray(t.grid_history.history)
    assert ht.shape == hj.shape and ht.shape[0] == 37
    np.testing.assert_allclose(ht, hj, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(t.field("v"), j.field("v"), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_array_equal(t.field("last_firing_time"),
                                  j.field("last_firing_time"))
    assert t.internal_clock == 37


def test_kernel_route_grid_history_matches_plain_route():
    """The rebuilt post-reset v of the kernel route against the plain
    route's per-step state.  The two sum the gather in different
    associations (fused vs XLA), which 40 steps keep within 1e-4."""
    a = torch_lattice(use_kernel=False)
    b = torch_lattice(use_kernel=True)
    for lat in (a, b):
        lat.update_grid_history = True
        lat.run_lattice(40)
    np.testing.assert_allclose(np.stack(b.grid_history.history),
                               np.stack(a.grid_history.history),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(b.field("last_firing_time"),
                                  a.field("last_firing_time"))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_1000_steps_within_reference_criterion(use_kernel):
    """1000 steps against the JAX XLA path under the reference's CPU-vs-GPU
    criterion (backend/tests/gpu_accuracy.rs:35-37): every voltage of the
    history within 2 mV, the final last firing times within 2 steps.  The
    kernel route crosses associations (fused vs XLA), so its trajectory
    departs from XLA's by rounding that spiking dynamics amplify."""
    j = jax_lattice()
    j.update_grid_history = True
    t = torch_lattice(use_kernel=use_kernel)
    t.update_grid_history = True
    j.run_lattice(1000)
    t.run_lattice(1000)
    hj = np.stack(j.grid_history.history)
    ht = np.stack(t.grid_history.history)
    assert np.abs(ht - hj).max() <= 2.0
    lj, lt = j.field("last_firing_time"), t.field("last_firing_time")
    assert np.abs(lt.astype(np.int64) - lj).max() <= 2
    assert (lt >= 900).any()


def test_unconnected_lattice_behaves_as_isolated_neurons():
    lat = snt.Lattice(snt.Izhikevich(), device="cpu")
    lat.populate(2, 2)
    lat.update_grid_history = True
    lat.run_lattice(100)
    got = np.stack(lat.grid_history.history).reshape(100, 4)
    ref = RefIzhikevich()
    want = []
    for _ in range(100):
        ref.iterate_and_spike(0.0)
        want.append(ref.v)
    for col in range(4):
        np.testing.assert_allclose(got[:, col], want, rtol=1e-5, atol=1e-4)
    j = snn.Lattice(snn.Izhikevich())
    j.populate(2, 2)
    j.update_grid_history = True
    j.run_lattice(100)
    np.testing.assert_allclose(got, np.stack(j.grid_history.history)
                               .reshape(100, 4), rtol=1e-6, atol=1e-5)


def test_set_dt_and_reset_timing_match_jax():
    j, t = jax_lattice(), torch_lattice()
    for lat in (j, t):
        lat.set_dt(0.5)
        lat.run_lattice(60)
    assert t.plasticity.params["dt"] == 0.5
    np.testing.assert_array_equal(t.field("dt"), j.field("dt"))
    np.testing.assert_allclose(t.field("v"), j.field("v"), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(t.field("last_firing_time"),
                                  j.field("last_firing_time"))
    t.reset_timing()
    assert t.internal_clock == 0
    assert int(t.state["last_firing_time"].max()) == -1
    assert t.state["last_firing_time"].dtype == torch.int32


def test_graph_history_appends_weights_per_step():
    for use_kernel in (False, True):
        t = torch_lattice(8, 8, V0[:64], use_kernel=use_kernel)
        t.update_graph_history = True
        t.run_lattice(3)
        t.run_lattice(4)
        assert len(t.graph_history) == 7
        for w in t.graph_history:
            np.testing.assert_array_equal(w, t.graph.weights.numpy())
        t.reset_history()
        assert t.graph_history == []


def test_plasticity_and_chemical_raise_not_implemented():
    """STDP and BCM run; a rule without an edge update of its own (R-STDP,
    which a `RewardModulatedLattice` runs) raises.  Chemical synapses run
    on a `Lattice` and on a `RewardModulatedLattice` (the plain route
    here)."""
    t = torch_lattice(4, 4, V0[:16])
    t.do_plasticity = True
    t.plasticity = snt.RewardModulatedSTDP()
    for use_kernel in (None, True, False):
        t.use_kernel = use_kernel
        with pytest.raises(NotImplementedError, match="STDP or BCM"):
            t.run_lattice(5)
    t.plasticity = snt.STDP()
    t.do_plasticity = False
    assert t.internal_clock == 0
    t.chemical_synapse = True
    t.run_lattice(5)
    assert t._last_run_fused is False and t.internal_clock == 5
    r = snt.RewardModulatedLattice(snt.Izhikevich(), device="cpu")
    r.populate(4, 4)
    r.chemical_synapse = True
    r.use_kernel = True
    r.run_lattice(5)
    assert r._last_run_fused is False and r.internal_clock == 5


def test_routing():
    """Auto takes the kernel route only on CUDA; an inserted NT, or a
    non-stencil graph, keeps the plain route even when the kernel is
    asked for."""
    t = torch_lattice(4, 4, V0[:16], use_kernel=None)
    t.run_lattice(3)
    assert t._last_run_fused is False
    t.use_kernel = True
    before = stencil_kernels.LAUNCHES
    t.run_lattice(3)
    assert t._last_run_fused == ("kernel", False)
    assert stencil_kernels.LAUNCHES == before      # CPU: the twin ran
    t.state = t.model.insert_neurotransmitter(t.state, "AMPA")
    t.run_lattice(3)
    assert t._last_run_fused is False
    u = snt.Lattice(snt.Izhikevich(), device="cpu")
    u.populate(3, 3)
    u.use_kernel = True
    u.run_lattice(2)
    assert u._last_run_fused is False
    assert u.voltages().shape == (3, 3)


def test_entry_points_default_to_the_card():
    """A lattice made without a device is on the GPU; nothing is
    allocated until `populate`, which needs one."""
    assert snt.Lattice(snt.Izhikevich()).device.type == "cuda"
    assert snt.RewardModulatedLattice(snt.Izhikevich()).device.type == "cuda"
    assert snt.SpikeTrainLattice(snt.RateSpikeTrain()).device.type == "cuda"
    assert snt.LatticeNetwork().device is None


def test_apply_given_position():
    t = snt.Lattice(snt.Izhikevich(), device="cpu")
    t.populate(3, 4)

    def fn(rr, cc, s):
        return {**s, "v": (rr * 10 + cc).to(torch.float32)}

    t.apply_given_position(fn)
    np.testing.assert_array_equal(
        t.voltages(), np.arange(3)[:, None] * 10 + np.arange(4)[None])

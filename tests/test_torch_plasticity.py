"""Plasticity in the PyTorch port against the JAX package on the CPU: the
ALIF and LIF models, the STDP and R-STDP rules, `connect(predicate)`, the
plain routes of the STDP `Lattice` and the `RewardModulatedLattice`
against the JAX XLA path, and carrying a JAX reward lattice across.

Tolerances: one elementwise step agrees to rtol 1e-6, atol 1e-5 (the JAX
package's fused-vs-XLA tolerance) with spikes and integers equal; runs of
a few hundred steps hold the same, since both sides compute the same ops
and differ only in the order of the 12-term gather sum and in the last
ulp of exp; 1000-step runs hold the reference's CPU-vs-GPU criterion
(2 mV, 2 steps; backend/tests/gpu_accuracy.rs:35-37).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.core import reward as jrw
from spiking_neural_networks_tpu.ops import graph as jg
from spiking_neural_networks_tpu_torch.core import reward as trw
from spiking_neural_networks_tpu_torch.core.plasticity import rule_tensors
from spiking_neural_networks_tpu_torch.convert import (
    state_from_numpy, stencil_graph_from_numpy, reward_lattice_from)
from spiking_neural_networks_tpu_torch.ops import graph as tg
from torch_lattices import (MODELS, RSTDP, assert_lattices_match,
                            jax_lattice, port_of)

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-5
REWARD = 0.005            # the 1000-step R-STDP runs' constant reward


def bench_predicate(x, y):
    """`bench.py`'s R-STDP graph: radius 2 without self-edges."""
    return np.hypot(x[0] - y[0], x[1] - y[1]) <= 2 and x != y


# -- models -------------------------------------------------------------------


@pytest.mark.parametrize("model", ["alif", "lif"])
def test_if_model_steps_match_jax(model):
    """200 steps from random v, w and refractory counts under a random
    drive: spikes and refractory counts equal at every step."""
    jcls, tcls = MODELS[model]
    n = 64
    rng = np.random.default_rng(1)
    host = jcls().init_state_host(n, tref=0.5)
    host["v"] = rng.uniform(-70, -54, n).astype(np.float32)
    if "w" in host:
        host["w"] = rng.uniform(-5, 5, n).astype(np.float32)
    host["refractory_count"] = rng.integers(0, 4, n).astype(np.float32)
    top = 3000.0 if model == "alif" else 500.0      # ALIF integrates / c_m
    drive = rng.uniform(-0.1 * top, top, (200, n)).astype(np.float32)
    js = {k: jnp.asarray(v) for k, v in host.items()}
    ts = state_from_numpy(host, "cpu")
    jm, tm = jcls(), tcls()
    fired = 0
    for i in drive:
        js, jspk = jm.step(js, jnp.asarray(i), skip_nt=True)
        ts, tspk = tm.step(ts, torch.from_numpy(i), skip_nt=True)
        np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk))
        np.testing.assert_array_equal(ts["refractory_count"].numpy(),
                                      np.asarray(js["refractory_count"]))
        fired += int(tspk.sum())
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert fired > n // 4


# -- rules --------------------------------------------------------------------


def _edge_inputs(seed=2, rows=7, cols=9):
    rng = np.random.default_rng(seed)
    jgr = jg.StencilGraph.build(rows, cols, jg.radius_offsets(2.0),
                                keep_prob=0.8, seed=seed,
                                weight_fn=lambda dr, dc, rr, cc:
                                rng.uniform(0.5, 1.5, rr.shape))
    tgr = stencil_graph_from_numpy(jgr.offsets, np.asarray(jgr.weights),
                                   np.asarray(jgr.mask),
                                   np.asarray(jgr.in_deg), "cpu")
    n = rows * cols
    lft = np.where(rng.random(n) < 0.7, rng.integers(0, 40, n),
                   -1).astype(np.int32)
    spk = rng.random(n) < 0.4
    return rng, jgr, tgr, lft, spk


def test_stdp_apply_matches_jax():
    _, jgr, tgr, lft, spk = _edge_inputs()
    p = dict(a_plus=2.0, a_minus=1.5, tau_plus=4.5, tau_minus=6.0, dt=0.1)
    want = snn.STDP().apply(jgr, {"last_firing_time": jnp.asarray(lft),
                                  "is_spiking": jnp.asarray(spk)},
                            {k: jnp.float32(v) for k, v in p.items()})
    got = snt.STDP().apply(tgr, {"last_firing_time": torch.from_numpy(lft),
                                 "is_spiking": torch.from_numpy(spk)},
                           rule_tensors(p, "cpu"))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               rtol=RTOL, atol=ATOL)
    assert np.abs(got.weights.numpy() - np.asarray(jgr.weights)).max() > 0.1
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


def test_rstdp_visits_match_jax():
    """`stdp_delta_arrays` on the edge views, then two `rstdp_visit`s from
    random traces with both counter values."""
    rng, jgr, tgr, lft, _ = _edge_inputs(seed=5)
    p = dict(RSTDP, dt=0.1, tau_plus=4.5, tau_minus=4.5)
    jp = {k: jnp.float32(v) for k, v in p.items()}
    tp = rule_tensors(p, "cpu")
    shp = tuple(jgr.weights.shape)
    c = rng.uniform(-1, 1, shp).astype(np.float32)
    dw = rng.uniform(-0.2, 0.2, shp).astype(np.float32)
    ct = rng.integers(0, 2, shp).astype(np.int32)
    jpre, jpost = jgr.edge_pre_post({"l": jnp.asarray(lft)},
                                    {"l": jnp.asarray(lft)})
    tpre, tpost = tgr.edge_pre_post({"l": torch.from_numpy(lft)},
                                    {"l": torch.from_numpy(lft)})
    jd = jrw.stdp_delta_arrays(jpre["l"], jpost["l"], jp)
    td = trw.stdp_delta_arrays(tpre["l"], tpost["l"], tp)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=ATOL)
    assert (td.numpy() > 0).any() and (td.numpy() < 0).any()
    jout = (jnp.asarray(np.asarray(jgr.weights)), jnp.asarray(c),
            jnp.asarray(dw), jnp.asarray(ct))
    tout = (tgr.weights, torch.from_numpy(c), torch.from_numpy(dw),
            torch.from_numpy(ct))
    for _ in range(2):
        jout = jrw.rstdp_visit(*jout, jd, jnp.float32(0.7), jp)
        tout = trw.rstdp_visit(*tout, td, torch.tensor(0.7), tp)
    for name, a, b in zip(("w", "c", "dw"), tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    assert tout[3].dtype == torch.int32


def test_stdp_apply_visits_matches_jax():
    _, jgr, tgr, lft, _ = _edge_inputs(seed=7)
    p = dict(a_plus=2.0, a_minus=1.5, tau_plus=4.5, tau_minus=6.0, dt=0.1)
    count = np.random.default_rng(8).integers(0, 3, jgr.weights.shape)
    jpre, jpost = jgr.edge_pre_post({"last_firing_time": jnp.asarray(lft)},
                                    {"last_firing_time": jnp.asarray(lft)})
    tpre, tpost = tgr.edge_pre_post(
        {"last_firing_time": torch.from_numpy(lft)},
        {"last_firing_time": torch.from_numpy(lft)})
    want = snn.STDP.apply_visits(jgr.weights, jpre, jpost,
                                 {k: jnp.float32(v) for k, v in p.items()},
                                 jnp.asarray(count, jnp.float32))
    got = snt.STDP.apply_visits(tgr.weights, tpre, tpost,
                                rule_tensors(p, "cpu"),
                                torch.from_numpy(count).to(torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# -- graphs -------------------------------------------------------------------


@pytest.mark.parametrize("pred,weight", [
    (bench_predicate, None),
    (lambda x, y: abs(x[0] - y[0]) + abs(x[1] - y[1]) == 1,
     lambda x, y: 0.5 + 0.1 * x[0] - 0.05 * y[1])])
def test_connect_predicate_array_equal(pred, weight):
    j = snn.Lattice(snn.Izhikevich())
    t = snt.Lattice(snt.Izhikevich(), device="cpu")
    for lat in (j, t):
        lat.populate(6, 5)
        lat.connect(pred, weight)
    assert t.graph.offsets == tuple(map(tuple, j.graph.offsets))
    for name in ("weights", "mask", "in_deg"):
        np.testing.assert_array_equal(getattr(t.graph, name).numpy(),
                                      np.asarray(getattr(j.graph, name)))


def test_bench_predicate_equals_connect_stencil():
    a = snt.RewardModulatedLattice(snt.Izhikevich(), device="cpu")
    b = snt.RewardModulatedLattice(snt.Izhikevich(), device="cpu")
    for lat in (a, b):
        lat.populate(7, 9)
    a.connect(bench_predicate)
    b.connect_stencil(radius=2.0)
    assert a.graph.offsets == b.graph.offsets
    for name in ("weights", "mask", "in_deg"):
        torch.testing.assert_close(getattr(a.graph, name),
                                   getattr(b.graph, name), rtol=0, atol=0)
    assert a.trace["counter"].shape == a.graph.weights.shape


def test_connect_wide_support_and_empty():
    t = snt.Lattice(snt.Izhikevich(), device="cpu")
    t.populate(4, 4)
    # offset support too wide for a stencil: a `DenseGraph`, as in the JAX
    # package; so is a predicate that holds nowhere
    t.connect(lambda x, y: x != y)
    assert isinstance(t.graph, tg.DenseGraph)
    assert int(t.graph.mask.sum()) == 16 * 15
    assert torch.equal(t.graph.weights, t.graph.mask.to(torch.float32))
    t.connect(lambda x, y: False)
    assert isinstance(t.graph, tg.DenseGraph) and not t.graph.has_edges
    assert t.graph.weights.shape == (16, 16)


# -- the plain routes against the JAX XLA path -------------------------------


@pytest.mark.parametrize("kind,model", [("plastic", "izhikevich"),
                                        ("plastic", "alif"),
                                        ("mod", "izhikevich"),
                                        ("mod", "lif")])
def test_plain_route_matches_jax_xla(kind, model):
    """150 steps from the same numbers, both on their plain routes."""
    j = jax_lattice(model, kind)
    t = port_of(j, model, use_kernel=False)
    rewards = np.linspace(-0.02, 0.05, 150).astype(np.float32)
    for lat in (j, t):
        if kind == "plastic":
            lat.run_lattice(150)
        else:
            lat.run_lattice_with_reward(rewards, 150)
    assert not j._last_run_fused and t._last_run_fused is False
    assert_lattices_match(t, j, RTOL, ATOL)


def _on_cpu(pkg):
    """The device argument of a port lattice in these tests."""
    return {} if pkg is snn else {"device": "cpu"}


def _bench_stdp(pkg, rows, cols):
    """`bench.py`'s STDP lattice: gap 10, radius 2, keep 0.8, graph seed
    5, v0 uniform in [-65, 25) from default_rng(9)."""
    lat = pkg.Lattice(pkg.Izhikevich(), **_on_cpu(pkg))
    lat.populate(rows, cols, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=5)
    lat.do_plasticity = True
    v0 = np.random.default_rng(9).uniform(-65, 25, rows * cols)
    lat.apply(lambda s: {**s, "v": (jnp.asarray(v0, jnp.float32)
                                    if pkg is snn else
                                    torch.as_tensor(v0, dtype=torch.float32))})
    return lat


def _bench_rstdp(pkg, rows, cols):
    """`bench.py`'s R-STDP lattice (gap 10, the radius-2 predicate), with
    v0 uniform in [-65, 30) from default_rng(0) so that it fires.  (From
    that v0 the bench's reward of 0.5 drives the dopamine to about 2000 and
    the weights without bound; the 1000-step test uses 0.005.)"""
    lat = pkg.RewardModulatedLattice(pkg.Izhikevich(), **_on_cpu(pkg))
    lat.populate(rows, cols, gap_conductance=10.0)
    lat.connect(bench_predicate)
    v0 = np.random.default_rng(0).uniform(-65, 30, rows * cols)
    lat.apply(lambda s: {**s, "v": (jnp.asarray(v0, jnp.float32)
                                    if pkg is snn else
                                    torch.as_tensor(v0, dtype=torch.float32))})
    return lat


@pytest.mark.parametrize("build", [_bench_stdp, _bench_rstdp])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_1000_steps_within_reference_criterion(build, use_kernel):
    """1000 steps at 16 x 16 against the JAX XLA path: every voltage of
    the history within 2 mV, the last firing times within 2 steps."""
    j, t = build(snn, 16, 16), build(snt, 16, 16)
    j.use_pallas = False
    t.use_kernel = use_kernel
    for lat in (j, t):
        lat.update_grid_history = True
    if build is _bench_rstdp:
        # the reward lattice runs histories on the plain route; the kernel
        # route is taken in chunks without one
        j.run_lattice_with_reward(REWARD, 1000)
        if use_kernel:
            t.update_grid_history = False
            hist = []
            for _ in range(10):
                t.run_lattice_with_reward(REWARD, 100)
                hist.append(t.voltages())
            hj = np.stack(j.grid_history.history)[99::100]
            ht = np.stack(hist)
            assert t._last_run_fused is True
        else:
            t.run_lattice_with_reward(REWARD, 1000)
            hj = np.stack(j.grid_history.history)
            ht = np.stack(t.grid_history.history)
        assert abs(t.dopamine - j.dopamine) <= 1e-5 * abs(j.dopamine)
    else:
        j.run_lattice(1000)
        t.run_lattice(1000)
        hj = np.stack(j.grid_history.history)
        ht = np.stack(t.grid_history.history)
        assert t._last_run_fused == (("stdp", True) if use_kernel else False)
    assert ht.shape[1:] == (16, 16)
    assert np.abs(ht - hj).max() <= 2.0
    lj = np.asarray(j.state["last_firing_time"])
    lt = t.state["last_firing_time"].numpy()
    assert np.abs(lt.astype(np.int64) - lj).max() <= 2
    assert (lt >= 900).any()
    assert np.abs(t.graph.weights.numpy()
                  - np.asarray(j.graph.weights)).max() <= 1e-2


# -- carrying a JAX reward lattice across --------------------------------------


@pytest.mark.parametrize("use_kernel", [False, True])
def test_reward_lattice_carried_over_runs_on_equal(use_kernel):
    """A JAX reward lattice after 30 steps, carried into the port, runs 40
    more steps equal to the JAX lattice (the same route family on both
    sides)."""
    j = jax_lattice("izhikevich", "mod", use_pallas=use_kernel)
    j.run_lattice_with_reward(0.1, 30)
    t = reward_lattice_from(j, snt.Izhikevich(), "cpu")
    t.use_kernel = use_kernel
    assert t.internal_clock == 33 and t.dopamine == j.dopamine
    assert t.trace["counter"].dtype == torch.int32
    for lat in (j, t):
        lat.run_lattice_with_reward(0.1, 25)
        lat.run_lattice(15)
    assert_lattices_match(t, j, RTOL, ATOL)


def test_reward_lattice_surface():
    t = snt.RewardModulatedLattice(snt.LeakyIntegrateAndFire(),
                                   device="cpu")
    t.populate(4, 5, v=-60.0)
    assert t.trace["c"].shape == (0,)
    t.update()                          # unconnected: the plain route
    t.connect_stencil(radius=1.0)
    assert t.trace["dw"].shape == t.graph.weights.shape
    t.set_dt(0.2)
    assert t.reward_modulator.params["dt"] == 0.2
    assert float(t.state["dt"][0]) == pytest.approx(0.2)
    t.update_and_apply_reward(1.0)
    assert t.dopamine == pytest.approx(20.0)
    assert t.internal_clock == 2
    t.reset_timing()
    assert t.internal_clock == 0 and int(t.state["last_firing_time"].max()) == -1
    assert t.voltages().shape == (4, 5)
    t.electrical_synapse = False
    t.run_lattice(3)
    assert t.internal_clock == 0
    # unconnected: STDP on no edges
    p = snt.Lattice(snt.Izhikevich(), device="cpu")
    p.populate(3, 3, v=40.0)
    p.do_plasticity = True
    p.run_lattice(2)
    assert p._last_run_fused is False and p.graph.weights.numel() == 0

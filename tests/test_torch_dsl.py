"""The port's DSL (``spiking_neural_networks_tpu_torch/dsl``) against the
JAX package's: each test of ``tests/test_dsl.py`` and
``tests/test_dsl_reference_suite.py`` has a counterpart here that builds
the port's model and the JAX package's from the same ``.nb`` source and
holds them together on the same seeded NumPy inputs:

* one step within rtol 1e-5;
* long runs within the reference's CPU-vs-GPU criterion: v within 2 mV
  away from spikes, and each neuron's spike steps within 2 steps;
* spike counts where the JAX test counts them.

Every test also keeps the JAX test's own assertion on the port's side.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu import attractors as jattractors
from spiking_neural_networks_tpu.core.history import (
    SpikeHistory as JSpikeHistory)
from spiking_neural_networks_tpu.dsl import neuron_builder as jnb
from spiking_neural_networks_tpu.models.spike_train import (
    REFRACTORINESS as JREFRACTORINESS)
from spiking_neural_networks_tpu.ops.graph import DenseGraph as JDenseGraph
from spiking_neural_networks_tpu_torch.attractors import (
    distort_pattern, generate_binary_hopfield_network,
    generate_hopfield_network, generate_random_patterns)
from spiking_neural_networks_tpu_torch.convert import lattice_from
from spiking_neural_networks_tpu_torch.core.history import SpikeHistory
from spiking_neural_networks_tpu_torch.dsl import neuron_builder as tnb
from spiking_neural_networks_tpu_torch.models.spike_train import (
    REFRACTORINESS as TREFRACTORINESS)

from test_dsl import (BOOL_VARS_NB, ELECTROCHEM_NB, FUNC_DECL_NB,
                      IZHIKEVICH_NB, TAN_NB)
from test_dsl_reference_suite import (DSL_IZHIKEVICH_NB, HH_NB, IF_HEADER,
                                      IONOTROPIC_NB, ML_NB,
                                      SHARED_RECEPTORS_NB, VOLTAGES)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
MV, STEPS = 2.0, 2


def both(src, name):
    """The JAX package's class and the port's, built from ``src``."""
    return jnb(src)[name], tnb(src)[name]


def to_port(state):
    """A JAX state dict as CPU tensors."""
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def f32(x):
    return np.asarray(x, np.float32)


def jax_run(model, s, i, steps, t_in=None, valid=None):
    """``steps`` JAX steps under one jitted scan: the final state and the
    (steps, n) voltages and spikes."""
    def body(s, _):
        s, sp = model.step(s, i) if t_in is None \
            else model.step(s, i, t_in, valid)
        return s, (s["v"], sp)

    s, (vs, sps) = jax.jit(lambda s: jax.lax.scan(body, s, None,
                                                  length=steps))(s)
    return s, np.asarray(vs), np.asarray(sps)


def port_run(model, s, i, steps, t_in=None, valid=None):
    """The same steps of the port model, in a host loop."""
    vs, sps = [], []
    for _ in range(steps):
        s, sp = model.step(s, i) if t_in is None \
            else model.step(s, i, t_in, valid)
        vs.append(s["v"])
        sps.append(sp)
    return s, torch.stack(vs).numpy(), torch.stack(sps).numpy()


def assert_step(ts, js, keys=None):
    """The float fields of one step's states within rtol 1e-5."""
    for k in keys or js:
        want = np.asarray(js[k])
        if want.dtype.kind == "f":
            np.testing.assert_allclose(ts[k].numpy(), want, rtol=RTOL,
                                       atol=ATOL, err_msg=k)


def assert_long_run(vt, vj, st, sj):
    """Each neuron's spike steps within 2 steps of the JAX run's, as many;
    v within 2 mV (or rtol 1e-5 where |v| runs past 2e5 mV, and equal
    where it overflows, as an unstable leak does) at the steps more than 2
    steps from any spike."""
    st, sj = np.asarray(st, bool), np.asarray(sj, bool)
    near = np.zeros_like(st)
    for n in range(st.shape[1]):
        tt, tj = np.nonzero(st[:, n])[0], np.nonzero(sj[:, n])[0]
        assert len(tt) == len(tj), (n, len(tt), len(tj))
        if len(tt):
            assert np.abs(tt - tj).max() <= STEPS, (n, tt, tj)
        for t in np.concatenate([tt, tj]):
            near[max(0, t - STEPS):t + STEPS + 1, n] = True
    vt, vj = np.asarray(vt, np.float64), np.asarray(vj, np.float64)
    same = (vt == vj) | (np.isnan(vt) & np.isnan(vj))
    with np.errstate(invalid="ignore"):
        d = np.abs(vt - vj) - np.maximum(MV, RTOL * np.abs(vj))
    d = np.where(same, -1.0, d)
    assert not np.isnan(d[~near]).any()
    assert d[~near].max(initial=0.0) <= 0.0, d[~near].max()


def step_pair(jm, tm, js, i, t_in=None, valid=None):
    """One step of both models from the same state, held within rtol
    1e-5; returns the port's."""
    ts = to_port(js)
    ti = torch.from_numpy(f32(i))
    if t_in is None:
        js2, _ = jm.step(js, jnp.asarray(i))
        ts2, _ = tm.step(ts, ti)
    else:
        js2, _ = jm.step(js, jnp.asarray(i), jnp.asarray(t_in),
                         jnp.asarray(valid))
        ts2, _ = tm.step(ts, ti, torch.from_numpy(np.asarray(t_in)),
                         torch.from_numpy(np.asarray(valid)))
    assert_step(ts2, js2)
    return ts2


# ---------------------------------------------------------------------------
# tests/test_dsl.py
# ---------------------------------------------------------------------------

def test_dsl_izhikevich_matches_jax_and_handwritten():
    J, T = both(IZHIKEVICH_NB, "DSLIzhikevich")
    i = f32([0.0, 10.0, 30.0, 50.0])
    js = J().init_state(4, v=-65.0)
    step_pair(J(), T(), js, i)
    js, vj, sj = jax_run(J(), js, jnp.asarray(i), 1000)
    ts, vt, st = port_run(T(), T().init_state(4, v=-65.0),
                          torch.from_numpy(i), 1000)
    assert_long_run(vt, vj, st, sj)
    # the JAX test's own: the hand-written model, another association
    h = snt.Izhikevich()
    hs = h.init_state(4)
    for _ in range(1000):
        hs, _ = h.step(hs, torch.from_numpy(i))
    for k in ("v", "w"):
        np.testing.assert_allclose(ts[k].numpy(), hs[k].numpy(), rtol=1e-6,
                                   atol=1e-4)


def test_dsl_izhikevich_chemical_matches_jax():
    J, T = both(IZHIKEVICH_NB, "DSLIzhikevich")
    jm, tm = J(), T()
    js = jm.init_state(2, v=-65.0)
    for t in ("AMPA", "NMDA", "GABA"):
        js = jm.insert_receptor(js, t)
    t_in = np.full((2, 3), 0.5, np.float32)
    valid = np.ones((2, 3), bool)
    i = f32([10.0, 40.0])
    step_pair(jm, tm, js, i, t_in, valid)
    ts = to_port(js)
    js, vj, sj = jax_run(jm, js, jnp.asarray(i), 500, jnp.asarray(t_in),
                         jnp.asarray(valid))
    ts, vt, st = port_run(tm, ts, torch.from_numpy(i), 500,
                          torch.from_numpy(t_in), torch.from_numpy(valid))
    assert_long_run(vt, vj, st, sj)
    # against the port's hand-written Izhikevich, as the JAX test does
    h = snt.Izhikevich()
    hs = h.init_state(2)
    for t in ("AMPA", "NMDA", "GABA"):
        hs = h.insert_receptor(hs, t)
    for _ in range(500):
        hs, _ = h.step(hs, torch.from_numpy(i), torch.from_numpy(t_in),
                       torch.from_numpy(valid))
    np.testing.assert_allclose(ts["v"].numpy(), hs["v"].numpy(), rtol=1e-6,
                               atol=1e-5)


LIF_NB = """[neuron]
    type: BasicIntegrateAndFire
    vars: e = 0, v_reset = -75, v_th = -55
    on_spike:
        v = v_reset
    spike_detection: v >= v_th
    on_iteration:
        dv/dt = (v - e) + i
[end]"""


def test_dsl_lif_nb_file_format(tmp_path):
    path = tmp_path / "lif.nb"
    path.write_text(LIF_NB)
    from spiking_neural_networks_tpu_torch.dsl import neuron_builder_from_file
    T = neuron_builder_from_file(str(path))["BasicIntegrateAndFire"]
    J = jnb(LIF_NB)["BasicIntegrateAndFire"]
    ts = T().init_state(1, v=-75.0)
    assert float(ts["e"][0]) == 0.0
    assert float(ts["gap_conductance"][0]) == 10.0   # injected default
    js = J().init_state(1, v=-75.0)
    step_pair(J(), T(), js, f32([50.0]))
    js, vj, sj = jax_run(J(), js, jnp.asarray([50.0]), 100)
    ts, vt, st = port_run(T(), ts, torch.tensor([50.0]), 100)
    assert np.isfinite(vt).all()
    assert_long_run(vt, vj, st, sj)


RATE_NB = """[spike_train]
    type: DSLRateSpikeTrain
    vars: step = 0., rate = 0.
    on_iteration:
        step += dt
        [if] rate != 0. && step >= rate [then]
            step = 0
            current_voltage = v_th
            is_spiking = true
        [else]
            current_voltage = v_resting
            is_spiking = false
        [end]
[end]"""


def test_dsl_rate_spike_train_matches_jax():
    J, T = both(RATE_NB, "DSLRateSpikeTrain")
    jm, tm = J(), T()
    key = jax.random.PRNGKey(0)
    js = jm.init_state(2, rate=1.0)
    ts = tm.init_state(2, rate=1.0)
    ref = snt.RateSpikeTrain()
    rs = ref.init_state(2, rate=1.0)
    fired = 0
    for clock in range(50):
        js, spj, key = jm.step(js, key, clock)
        ts, spt = tm.step(ts, None, clock)
        rs, spr = ref.step(rs, None, clock)
        np.testing.assert_array_equal(spt.numpy(), np.asarray(spj))
        np.testing.assert_array_equal(ts["v"].numpy(), np.asarray(js["v"]))
        np.testing.assert_array_equal(spt.numpy(), spr.numpy())
        fired += int(spt.sum())
    assert fired > 0


BOUNDED_DOPA_NB = """
[neurotransmitter_kinetics]
    type: TDSLBoundedNeurotransmitterKinetics
    vars: t_max = 1, clearance_constant = 0.001, conc = 0
    on_iteration:
        [if] is_spiking [then]
            conc = t_max
        [else]
            conc = 0
        [end]

        t = t + dt * -clearance_constant * t + conc

        t = min(max(t, 0), t_max)
[end]

[receptor_kinetics]
    type: TDSLBoundedReceptorKinetics
    vars: r_max = 1
    on_iteration:
        r = min(max(t, 0), r_max)
[end]

[receptors]
    type: TDSLDopaGluGABA
    kinetics: TDSLBoundedReceptorKinetics
    vars: inh_modifier = 1, nmda_modifier = 1
    neurotransmitter: Glutamate
    receptors: ampa_r, nmda_r
    vars: current = 0, g_ampa = 1, g_nmda = 0.6, e_ampa = 0, e_nmda = 0, mg = 0.3
    on_iteration:
        current = inh_modifier * g_ampa * ampa_r * (v - e_ampa) + (1 / (1 + (exp(-0.062 * v) * mg / 3.57))) * inh_modifier * g_nmda * (nmda_r r^ nmda_modifier) * (v - e_nmda)
    neurotransmitter: GABA
    vars: current = 0, g = 1.2, e = -80
    on_iteration:
        current = g * r * (v - e)
    neurotransmitter: Dopamine
    receptors: r_d1, r_d2
    vars: s_d2 = 0, s_d1 = 0
    on_iteration:
        inh_modifier = 1 - (r_d2 * s_d2)
        nmda_modifier = 1 - (r_d1 * s_d1)
[end]

[neuron]
    type: TDSLDopaIzhikevich
    kinetics: TDSLBoundedNeurotransmitterKinetics, TDSLBoundedReceptorKinetics
    receptors: TDSLDopaGluGABA
    vars: w = 30, a = 0.02, b = 0.2, c = -55, d = 8, v_th = 30, tau_m = 1, c_m = 100
    on_spike:
        v = c
        w += d
    spike_detection: v >= v_th
    on_iteration:
        dw/dt = (a * (b * v - w)) / tau_m
        dv/dt = (0.04 * v * v + 5 * v + 140 - w + i) / c_m
[end]
"""


def test_dsl_bounded_kinetics_and_dopa_receptors_match_jax():
    """The lixirnet model definition (`tests/test_dsl.py`'s, under its own
    type names): the port's generated DopaIzhikevich against the JAX
    package's, NT release included, and against the port's hand-built
    DopaIzhikevich."""
    J, T = both(BOUNDED_DOPA_NB, "TDSLDopaIzhikevich")
    jm, tm = J(), T()
    assert tm.type_names == ("Glutamate", "GABA", "Dopamine")
    js = jm.init_state(2, v=-65.0)
    for t in ("Glutamate", "GABA", "Dopamine"):
        js = jm.insert_receptor(js, t)
    js["rec$Dopamine$s_d2"] = jnp.full((2,), 0.8, jnp.float32)
    js = jm.insert_neurotransmitter(js, "Glutamate")
    t_in = f32([[0.7, 0.2, 0.6], [0.7, 0.2, 0.6]])
    valid = np.ones((2, 3), bool)
    i = f32([20.0, 35.0])
    step_pair(jm, tm, js, i, t_in, valid)
    ts = to_port(js)
    js, vj, sj = jax_run(jm, js, jnp.asarray(i), 500, jnp.asarray(t_in),
                         jnp.asarray(valid))
    ts, vt, st = port_run(tm, ts, torch.from_numpy(i), 500,
                          torch.from_numpy(t_in), torch.from_numpy(valid))
    assert_long_run(vt, vj, st, sj)
    np.testing.assert_allclose(ts["nt$t"].numpy(), np.asarray(js["nt$t"]),
                               rtol=1e-5, atol=1e-6)
    hand = snt.DopaIzhikevich()
    hs = hand.init_state(2)
    for t in ("Glutamate", "GABA", "Dopamine"):
        hs = hand.insert_receptor(hs, t)
    hs["rec$s_d2"] = torch.full((2,), 0.8)
    hs = hand.insert_neurotransmitter(hs, "Glutamate")
    for _ in range(500):
        hs, _ = hand.step(hs, torch.from_numpy(i), torch.from_numpy(t_in),
                          torch.from_numpy(valid))
    np.testing.assert_allclose(ts["v"].numpy(), hs["v"].numpy(), rtol=1e-5,
                               atol=1e-4)


CHANNEL_LIF_NB = """
[ion_channel]
    type: TestLeak
    vars: e = 0, g = 1
    on_iteration:
        current = g * (v - e)
[end]

[neuron]
    type: ChannelLIF
    ion_channels: l = TestLeak
    vars: v_reset = -75, v_th = -55
    on_spike:
        v = v_reset
    spike_detection: v >= v_th
    on_iteration:
        l.update_current(v)
        dv/dt = l.current + i
[end]
"""


def test_dsl_ion_channel_based_neuron_matches_jax():
    J, T = both(CHANNEL_LIF_NB, "ChannelLIF")
    ts = T().init_state(2, v=-75.0)
    assert "l$current" in ts and "l$g" in ts
    js = J().init_state(2, v=-75.0)
    i = f32([20.0, 20.0])
    step_pair(J(), T(), js, i)
    js, vj, sj = jax_run(J(), js, jnp.asarray(i), 300)
    ts, vt, st = port_run(T(), ts, torch.from_numpy(i), 300)
    assert_long_run(vt, vj, st, sj)
    # the JAX test's independent Euler: v += dt * (g (v - e) + i)
    v_ref = np.float32(-75.0)
    for k in range(300):
        v_ref = v_ref + np.float32(0.1) * ((v_ref - np.float32(0.0))
                                           + np.float32(20.0))
        if v_ref >= -55.0:
            v_ref = np.float32(-75.0)
        np.testing.assert_allclose(vt[k, 0], v_ref, rtol=1e-5, atol=1e-4)


GATING_NB = """
[ion_channel]
    type: TestChannel
    vars: e = 0, g = 1
    gating_vars: n
    on_iteration:
        current = g * n.alpha * n.beta * n.state * (v - e)
[end]
"""


def test_dsl_gating_variable_channel_matches_jax():
    J, T = both(GATING_NB, "TestChannel")
    jl, tl = J(), T()
    for ch in (jl, tl):
        ch.set_gating("n", alpha=1.0, beta=1.0, state=1.0)
    for v in [-50.0, -20.0, 0.0, 30.0]:
        got = tl.update_current(v)
        assert abs(got - v) < 1e-6
        np.testing.assert_allclose(got, float(jl.update_current(v)),
                                   rtol=RTOL)
    tl.g = 2.0
    for v in [-50.0, 10.0]:
        assert abs(tl.update_current(v) - 2 * v) < 1e-5


GATE_UPDATE_NB = """
[ion_channel]
    type: GateChan
    vars: g = 2, e = -10
    gating_vars: m
    on_iteration:
        m.update(dt)
        current = g * m.state * (v - e)
[end]
"""


def test_dsl_gating_update_in_channel_matches_jax():
    J, T = both(GATE_UPDATE_NB, "GateChan")
    jl, tl = J(), T()
    for ch in (jl, tl):
        ch.set_gating("m", alpha=0.5, beta=0.25, state=0.0)
    cur = tl.update_current(0.0, dt=0.1)
    np.testing.assert_allclose(float(tl.state["m$state"][0]), 0.05,
                               rtol=1e-6)
    np.testing.assert_allclose(cur, 2 * 0.05 * 10.0, rtol=1e-5)
    np.testing.assert_allclose(cur, float(jl.update_current(0.0, dt=0.1)),
                               rtol=RTOL)


def chem_pair(J, T, n, mods=None, inserts=("AMPA", "NMDA", "GABA"),
              nts=("AMPA",)):
    jm, tm = J(), T()
    js = jm.init_state(n, v=-65.0, **(mods or {}))
    for t in inserts:
        js = jm.insert_receptor(js, t)
    for t in nts:
        js = jm.insert_neurotransmitter(js, t)
    return jm, tm, js


def test_dsl_custom_electrochemical_iteration_matches_jax():
    """The custom [on_electrochemical_iteration] body of the template: the
    port against the JAX package, NT included; against the port's built-in
    chemical path; a modifier of 2 diverges; the electrical path still
    takes on_iteration."""
    J, T = both(ELECTROCHEM_NB, "ElectroChemIzhikevich")
    jm, tm, js = chem_pair(J, T, 2)
    t_in = np.full((2, 3), 0.5, np.float32)
    valid = np.ones((2, 3), bool)
    i = f32([10.0, 40.0])
    step_pair(jm, tm, js, i, t_in, valid)
    ts0 = to_port(js)
    js, vj, sj = jax_run(jm, js, jnp.asarray(i), 300, jnp.asarray(t_in),
                         jnp.asarray(valid))
    ts, vt, st = port_run(tm, ts0, torch.from_numpy(i), 300,
                          torch.from_numpy(t_in), torch.from_numpy(valid))
    assert_long_run(vt, vj, st, sj)
    np.testing.assert_allclose(ts["nt$t"].numpy(), np.asarray(js["nt$t"]),
                               rtol=1e-6, atol=1e-6)
    ref = snt.Izhikevich()
    rs = ref.init_state(2)
    for t in ("AMPA", "NMDA", "GABA"):
        rs = ref.insert_receptor(rs, t)
    rs = ref.insert_neurotransmitter(rs, "AMPA")
    for _ in range(300):
        rs, _ = ref.step(rs, torch.from_numpy(i), torch.from_numpy(t_in),
                         torch.from_numpy(valid))
    np.testing.assert_allclose(ts["v"].numpy(), rs["v"].numpy(), rtol=1e-6,
                               atol=1e-5)
    s3 = dict(ts0, modifier=torch.full((2,), 2.0))
    s3, _, _ = port_run(tm, s3, torch.from_numpy(i), 300,
                        torch.from_numpy(t_in), torch.from_numpy(valid))
    assert not np.allclose(s3["v"].numpy(), ts["v"].numpy())
    s4, v4, sp4 = port_run(tm, tm.init_state(2, v=-65.0),
                           torch.from_numpy(i), 300)
    j4, vj4, sj4 = jax_run(jm, jm.init_state(2, v=-65.0), jnp.asarray(i),
                           300)
    assert_long_run(v4, vj4, sp4, sj4)


def test_dsl_electrochemical_in_chemical_lattice_matches_jax():
    """The custom electrochemical body inside a chemical-synapse lattice
    (the plain route), carried over from the JAX package's lattice with
    ``convert.lattice_from(..., model=)``."""
    J, T = both(ELECTROCHEM_NB, "ElectroChemIzhikevich")
    jm = J()
    lat = snn.Lattice(jm)
    lat.populate(4, 4, gap_conductance=10.0)
    lat.connect_stencil(radius=1.5, seed=0)
    lat.electrical_synapse = False
    lat.chemical_synapse = True
    s = lat.state
    for t in ("AMPA", "NMDA"):
        s = jm.insert_receptor(s, t)
        s = jm.insert_neurotransmitter(s, t)
    s["v"] = jnp.asarray(
        np.random.default_rng(0).uniform(-65, 30, 16), jnp.float32)
    lat.state = s
    port = lattice_from(lat, model=T(), device="cpu")
    lat.run_lattice(200)
    port.run_lattice(200)
    v = port.state["v"].numpy()
    assert np.isfinite(v).all()
    assert float(port.state["nt$t"].abs().max()) > 0.0
    np.testing.assert_allclose(v, np.asarray(lat.state["v"]), atol=MV)
    assert np.abs(port.state["last_firing_time"].numpy()
                  - np.asarray(lat.state["last_firing_time"])).max() <= STEPS


def test_dsl_func_declaration_matches_jax():
    J, T = both(FUNC_DECL_NB, "FuncDeclNeuron")
    i = f32([0.0, 5.0, 20.0])
    js = J().init_state(3, v=-70.0)
    step_pair(J(), T(), js, i)
    js, vj, sj = jax_run(J(), js, jnp.asarray(i), 500)
    ts, vt, st = port_run(T(), T().init_state(3, v=-70.0),
                          torch.from_numpy(i), 500)
    assert_long_run(vt, vj, st, sj)
    # the hand-written equivalent of the JAX test
    v = np.full(3, -70.0, np.float32)
    for _ in range(500):
        dv = ((0.0 - v) + 2.0 * i) + (0.5 + 2.0 * 0.5 - 0.0)
        v = v + 0.1 * dv
        v = np.where(v >= -55.0, -75.0, v)
    np.testing.assert_allclose(ts["v"].numpy(), v, rtol=1e-5, atol=1e-4)


def test_dsl_bool_vars_match_jax():
    J, T = both(BOOL_VARS_NB, "BoolVarNeuron")
    js = J().init_state(2, v=-70.0)
    js["flag"] = jnp.asarray([0.0, 1.0])
    ts = step_pair(J(), T(), js, f32([0.0, 0.0]))
    np.testing.assert_array_equal(ts["out"].numpy(), [2.0, 1.0])


def test_dsl_builtin_functions_sweep_matches_jax():
    J, T = both(TAN_NB, "TanNeuron")
    inputs = np.arange(-10, 10, dtype=np.float32)
    js = J().init_state(20)
    ts = step_pair(J(), T(), js, inputs)
    np.testing.assert_allclose(ts["v"].numpy(), np.tan(inputs), rtol=1e-6)


LEAK_ASSIGN_NB = """
[ion_channel]
    type: SimpleLeak
    vars: current = 0, e = -80, g = 0.1
    on_iteration:
        current = g * (v - e)
[end]

[neuron]
    type: LeakAssignNeuron
    vars: v_reset = -75, v_th = -55
    ion_channels: l1 = SimpleLeak, l2 = SimpleLeak
    on_spike:
        v = v_reset
    spike_detection: v >= v_th
    on_iteration:
        l1.update_current(v)
        l2.update_current(v)
        dv/dt = i - l1.current - l2.current
[end]
"""


def test_dsl_struct_assignment_ion_channels_match_jax():
    J, T = both(LEAK_ASSIGN_NB, "LeakAssignNeuron")
    js = J().init_state(2, v=-70.0)
    ts = step_pair(J(), T(), js, f32([0.0, 0.0]))
    assert "l1$current" in ts and "l2$current" in ts
    np.testing.assert_allclose(ts["l1$current"].numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(ts["v"].numpy(),
                               -70.0 + 0.1 * (0.0 - 1.0 - 1.0), rtol=1e-6)


DUP_VAR_NB = """
[neuron]
    type: DupVarNeuron
    vars: e = 0, e = 1, v_reset = -75, v_th = -55
    on_spike:
        v = v_reset
    spike_detection: v >= v_th
    on_iteration:
        dv/dt = (v - e) + i
[end]
"""
TWICE_NB = """
[neuron]
    type: TwiceDefined
    vars: e = 0
    on_spike:
        v = -75
    spike_detection: v >= -55
    on_iteration:
        dv/dt = (v - e) + i
[end]
"""


@pytest.mark.parametrize("src,match", [
    (DUP_VAR_NB, "duplicate variable"),
    (TWICE_NB + TWICE_NB, "duplicate definition")])
def test_dsl_duplicates_rejected_as_jax(src, match):
    with pytest.raises(SyntaxError, match=match):
        tnb(src)
    with pytest.raises(SyntaxError, match=match):
        jnb(src)


MINIMAL_NB = """
[neuron]
    type: MinimalNeuron
    vars: e = 0
    on_spike:
        v = -75
    spike_detection: v >= -55
    on_iteration:
        dv/dt = (v - e) + i
[end]
"""


def test_dsl_mandatory_vars_injected_as_jax():
    J, T = both(MINIMAL_NB, "MinimalNeuron")
    ts, js = T().init_state(4), J().init_state(4)
    for key in ("v", "is_spiking", "last_firing_time", "dt",
                "gap_conductance"):
        assert key in ts, key
    assert ts["v"].shape == (4,)
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))


REFRACTORINESS_NB = """
[neural_refractoriness]
    type: TestRefractoriness
    effect: (v_th - v_resting) * exp((-1 / (decay / dt)) * (time_difference ^ 2)) + v_resting
[end]
"""


def test_dsl_neural_refractoriness_matches_jax_and_delta_dirac():
    tnb(REFRACTORINESS_NB)
    jnb(REFRACTORINESS_NB)
    assert "TestRefractoriness" in TREFRACTORINESS
    rng = np.random.default_rng(3)
    for _ in range(50):
        decay = f32(rng.uniform(0.0, 20000.0))
        lft = int(rng.integers(0, 1000))
        timestep = int(rng.integers(lft, lft + 1000))
        v_max = f32(rng.uniform(10.0, 30.0))
        args = (decay, v_max - f32(0.0), f32(timestep - lft), f32(0.0),
                f32(0.1))
        t_args = [torch.tensor(a) for a in args]
        ours = TREFRACTORINESS["delta_dirac"](*t_args)
        gen = TREFRACTORINESS["TestRefractoriness"](*t_args)
        jgen = JREFRACTORINESS["TestRefractoriness"](
            *[jnp.float32(a) for a in args])
        np.testing.assert_allclose(float(gen), float(ours), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(float(gen), float(jgen), rtol=RTOL,
                                   atol=1e-7)


CALCIUM_NB = """
[ion_channel]
    type: CalciumIonChannel
    vars: e = 80, g = 0.025
    gating_vars: s
    on_iteration:
        s.alpha = 1.6 / (1 + exp(-0.072 * (v - 5)))
        s.beta = (0.02 * (v + 8.9)) / ((exp(v + 8.9) / 5) - 1)
        s.update(dt)
        current = g * -(s.state ^ 2) * (v - e)
[end]
"""


def test_dsl_timestep_dependent_ion_channel_matches_jax():
    """The calcium channel at 9 voltages x 200 steps, batched as one
    9-neuron channel: the port against the JAX package's generated
    channel."""
    J, T = both(CALCIUM_NB, "CalciumIonChannel")
    volts = f32([-50.0, -40.0, -30.0, -20.0, -10.0, 0.0, 10.0, 20.0, 30.0])
    jl, tl = J(n=9), T(n=9)
    for _ in range(200):
        jc = jl.update_current(jnp.asarray(volts), dt=0.01)
        tc = tl.update_current(torch.from_numpy(volts), dt=0.01)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL,
                               atol=1e-8)
    assert np.isfinite(tc.numpy()).all()


# ---------------------------------------------------------------------------
# tests/test_dsl_reference_suite.py
# ---------------------------------------------------------------------------

def test_dsl_hodgkin_huxley_matches_jax():
    J, T = both(HH_NB, "DSLHodgkinHuxley")
    i = np.linspace(0.0, 100.0, 11).astype(np.float32)
    js = J().init_state(11, v=-65.0, dt=0.01)
    step_pair(J(), T(), js, i)
    js, vj, sj = jax_run(J(), js, jnp.asarray(i), 2000)
    ts, vt, st = port_run(T(), T().init_state(11, v=-65.0, dt=0.01),
                          torch.from_numpy(i), 2000)
    assert_long_run(vt, vj, st, sj)
    assert st.sum() > 0, "vacuous: HH never spiked"


def test_dsl_morris_lecar_matches_jax():
    J, T = both(ML_NB, "DSLMorrisLecar")
    i = np.linspace(0.0, 200.0, 9).astype(np.float32)
    js = J().init_state(9, v=-70.0, dt=0.01)
    step_pair(J(), T(), js, i)
    js, vj, sj = jax_run(J(), js, jnp.asarray(i), 3000)
    ts, vt, st = port_run(T(), T().init_state(9, v=-70.0, dt=0.01),
                          torch.from_numpy(i), 3000)
    assert_long_run(vt, vj, st, sj)
    assert st.sum() > 0, "vacuous: ML never spiked"


IF_VARIANTS = {
    "BasicIf": (", flag = 0", """\
        [if] i < 0 [then]
            flag = 1
        [end]
""", lambda x: {"flag": np.where(x < 0, 1.0, 0.0)}),
    "NestedIf": (", flag1 = 0, flag2 = 0", """\
        [if] i < 0 [then]
            flag1 = 1
            [if] i > -30 [then]
                flag2 = 2
            [end]
        [end]
""", lambda x: {"flag1": np.where(x < 0, 1.0, 0.0),
                "flag2": np.where((x < 0) & (x > -30), 2.0, 0.0)}),
    "ElseIfNeuron": (", flag = 0", """\
        [if] i < 0 [then]
            flag = 1
        [else]
            flag = 2
        [end]
""", lambda x: {"flag": np.where(x < 0, 1.0, 2.0)}),
    "ElseIf2": (", flag = 0", """\
        [if] i < 0 [then]
            flag = 1
        [elseif] i > 30 [then]
            flag = 2
        [end]
""", lambda x: {"flag": np.where(x < 0, 1.0, np.where(x > 30, 2.0, 0.0))}),
    "ElseIf3": (", flag = 0", """\
        [if] i < 0 [then]
            flag = 1
        [elseif] i > 30 [then]
            flag = 2
        [else]
            flag = 3
        [end]
""", lambda x: {"flag": np.where(x < 0, 1.0, np.where(x > 30, 2.0, 3.0))}),
    "ElseIf4": (", flag = 0", """\
        [if] i < 0 [then]
            flag = 1
        [elseif] i > 20 [then]
            flag = 2
        [elseif] i > 0 [then]
            flag = 3
        [else]
            flag = 4
        [end]
""", lambda x: {"flag": np.where(x < 0, 1.0, np.where(
        x > 20, 2.0, np.where(x > 0, 3.0, 4.0)))}),
    "ElseIfNested": (", flag = 0", """\
        [if] i < 0 [then]
            flag = 1
        [elseif] i > 20 [then]
            [if] i >= 40 [then]
                flag = 2
            [else]
                flag = 3
            [end]
        [else]
            flag = 4
        [end]
""", lambda x: {"flag": np.where(x < 0, 1.0, np.where(
        x > 20, np.where(x >= 40, 2.0, 3.0), 4.0))}),
}


@pytest.mark.parametrize("name", sorted(IF_VARIANTS))
def test_dsl_if_statement_variants_match_jax(name):
    """Every if / elseif / else / nesting shape of the reference suite:
    the voltage trajectory equal to the plain LIF's (port), the flags as
    expected, and the port within the JAX package's run."""
    extra, body, flags = IF_VARIANTS[name]
    src = IF_HEADER.format(name=name, extra_vars=extra, body=body)
    plain = IF_HEADER.format(name="PlainLIF", extra_vars="", body="")
    J, T = both(src, name)
    P = tnb(plain)["PlainLIF"]
    i = VOLTAGES
    js = J().init_state(11, v=0.0)
    step_pair(J(), T(), js, i)
    js, vj, sj = jax_run(J(), js, jnp.asarray(i), 1000)
    ts, vt, st = port_run(T(), T().init_state(11, v=0.0),
                          torch.from_numpy(i), 1000)
    _, vp, _ = port_run(P(), P().init_state(11, v=0.0), torch.from_numpy(i),
                        1000)
    np.testing.assert_array_equal(vt, vp)
    assert_long_run(vt, vj, st, sj)
    for k, want in flags(VOLTAGES).items():
        np.testing.assert_array_equal(ts[k].numpy(), want)
        np.testing.assert_array_equal(np.asarray(js[k]), want)


@pytest.fixture(scope="module")
def shared_receptors():
    return jnb(SHARED_RECEPTORS_NB), tnb(SHARED_RECEPTORS_NB)


def counts_pair(J, T, js, i, t_in, valid, steps):
    """Spike counts per neuron of both packages over ``steps`` steps from
    the JAX state ``js``."""
    ts = to_port(js)
    _, _, sj = jax_run(J, js, jnp.asarray(i), steps, jnp.asarray(t_in),
                       jnp.asarray(valid))
    _, _, st = port_run(T, ts, torch.from_numpy(i), steps,
                        torch.from_numpy(t_in), torch.from_numpy(valid))
    return st.astype(np.int64).sum(axis=0), sj.astype(np.int64).sum(axis=0)


RECEPTOR_STEPS = 2000


def test_dsl_shared_multiple_receptors_match_jax(shared_receptors):
    """More inserted receptor types -> more spikes, the port's counts over
    `RECEPTOR_STEPS` steps those of the JAX package."""
    jout, tout = shared_receptors
    J, T = jout["MultiIntegrateAndFire"](), tout["MultiIntegrateAndFire"]()
    assert T.type_names == ("A", "B")
    js = J.init_state(3, v=0.0)
    mask = np.zeros((3, 2), bool)
    mask[1, 0] = mask[2, 0] = mask[2, 1] = True
    js["rec$mask"] = jnp.asarray(mask)
    js["rec$A$g"] = jnp.full((3,), 2.0, jnp.float32)
    js["rec$B$g"] = jnp.full((3,), 2.0, jnp.float32)
    t_in, valid = np.ones((3, 2), np.float32), np.ones((3, 2), bool)
    step_pair(J, T, js, np.zeros(3, np.float32), t_in, valid)
    ct, cj = counts_pair(J, T, js, np.zeros(3, np.float32), t_in, valid,
                         RECEPTOR_STEPS)
    assert np.abs(ct - cj).max() <= 1, (ct, cj)
    assert ct[0] < ct[1] < ct[2], ct


def test_dsl_mixed_metabotropic_receptors_match_jax(shared_receptors):
    jout, tout = shared_receptors
    J, T = jout["MixedIntegrateAndFire"](), tout["MixedIntegrateAndFire"]()
    js = J.init_state(3, v=0.0)
    mask = np.zeros((3, 2), bool)
    meta, iono = T.type_index("Meta"), T.type_index("Iono")
    mask[1, meta] = mask[2, meta] = mask[2, iono] = True
    js["rec$mask"] = jnp.asarray(mask)
    js["rec$Iono$g"] = jnp.full((3,), 2.0, jnp.float32)
    t_in, valid = np.ones((3, 2), np.float32), np.ones((3, 2), bool)
    step_pair(J, T, js, np.zeros(3, np.float32), t_in, valid)
    ct, cj = counts_pair(J, T, js, np.zeros(3, np.float32), t_in, valid,
                         RECEPTOR_STEPS)
    assert np.abs(ct - cj).max() <= 1, (ct, cj)
    assert ct[0] == ct[1], ct       # meta alone adds no current
    assert ct[1] < ct[2], ct        # meta gates iono on


def test_dsl_combined_two_slot_receptors_match_jax(shared_receptors):
    jout, tout = shared_receptors
    tc, tmul = tout["CombinedIntegrateAndFire"](), \
        tout["MultiIntegrateAndFire"]()
    jc = jout["CombinedIntegrateAndFire"]()
    for t in (0.0, 0.3, 0.7, 1.0):
        js1 = jc.init_state(1, v=0.0, dt=1.0)
        js1 = jc.insert_receptor(js1, "Combined")
        s1 = to_port(js1)
        s2 = tmul.init_state(1, v=0.0, dt=1.0)
        s2 = tmul.insert_receptor(s2, "A", **{"A$g": 2.0})
        s2 = tmul.insert_receptor(s2, "B", **{"B$g": 1.0})
        t1, t2 = np.full((1, 1), t, np.float32), np.full((1, 2), t,
                                                         np.float32)
        v1, v2 = np.ones((1, 1), bool), np.ones((1, 2), bool)
        step_pair(jc, tc, js1, np.zeros(1, np.float32), t1, v1)
        for _ in range(200):
            s1, sp1 = tc.step(s1, torch.zeros(1), torch.from_numpy(t1),
                              torch.from_numpy(v1))
            s2, sp2 = tmul.step(s2, torch.zeros(1), torch.from_numpy(t2),
                                torch.from_numpy(v2))
            assert bool(sp1[0]) == bool(sp2[0])
        np.testing.assert_allclose(float(s1["rec$r"][0, 0]), t, atol=1e-6)
        np.testing.assert_allclose(float(s1["rec$r2"][0, 0]), t, atol=1e-6)
        a, b = s1["v"].numpy(), s2["v"].numpy()
        finite = np.isfinite(a) & np.isfinite(b)
        np.testing.assert_allclose(a[finite], b[finite], rtol=1e-4)
        js1, _, _ = jax_run(jc, js1, jnp.zeros(1), 200, jnp.asarray(t1),
                            jnp.asarray(v1))
        np.testing.assert_allclose(a[finite], np.asarray(js1["v"])[finite],
                                   rtol=1e-4)


def test_dsl_custom_electrochemical_differing_matches_jax(shared_receptors):
    jout, tout = shared_receptors
    jcu, tcu = jout["ElectroChemicalIntegrateAndFire"](), \
        tout["ElectroChemicalIntegrateAndFire"]()
    jpl, tpl = jout["MultiIntegrateAndFire"](), \
        tout["MultiIntegrateAndFire"]()
    n = 6
    ts_ = np.linspace(0.0, 1.0, 6).astype(np.float32)
    t_in = np.stack([ts_, ts_], axis=1)
    valid = np.ones((n, 2), bool)
    j1 = jcu.init_state(n, v=0.0, dt=1.0, modifier=3.0)
    j2 = jpl.init_state(n, v=0.0, dt=1.0)
    for name, g in (("A", 2.0), ("B", 2.0)):
        j1 = jcu.insert_receptor(j1, name, **{f"{name}$g": g})
        j2 = jpl.insert_receptor(j2, name, **{f"{name}$g": g})
    step_pair(jcu, tcu, j1, np.zeros(n, np.float32), t_in, valid)
    c1, cj1 = counts_pair(jcu, tcu, j1, np.zeros(n, np.float32), t_in, valid,
                          1000)
    c2, cj2 = counts_pair(jpl, tpl, j2, np.zeros(n, np.float32), t_in, valid,
                          1000)
    assert np.abs(c1 - cj1).max() <= 1 and np.abs(c2 - cj2).max() <= 1
    assert int(c1.sum()) > int(c2.sum()), (c1, c2)


KINETICS_NB = """
[neurotransmitter_kinetics]
    type: TDefBoundedNT
    vars: t_max = 1, c = 0.001, conc = 0
    on_iteration:
        [if] is_spiking [then]
            conc = t_max
        [else]
            conc = 0
        [end]
        t = t + dt * -c * t + conc
        t = min(max(t, 0), t_max)
[end]

[receptor_kinetics]
    type: TDefBoundedRec
    vars: r_max = 1
    on_iteration:
        r = min(max(t, 0), r_max)
[end]

[neuron]
    type: TDefBasicIntegrateAndFire
    kinetics: TDefBoundedNT, TDefBoundedRec
    vars: e = 0, v_reset = -75, v_th = -55
    on_spike:
        v = v_reset
    spike_detection: v >= v_th
    on_iteration:
        dv/dt = -(v - e) + i
[end]
"""


def test_dsl_kinetics_default_impl_matches_jax():
    jout, tout = jnb(KINETICS_NB), tnb(KINETICS_NB)
    jm, tm = jout["TDefBasicIntegrateAndFire"](), \
        tout["TDefBasicIntegrateAndFire"]()
    assert tm.nt_kinetics == tout["TDefBoundedNT"]
    assert tm.rec_kinetics == tout["TDefBoundedRec"]
    js = jm.init_state(1, v=-60.0)
    js = jm.insert_neurotransmitter(js, "AMPA")
    step_pair(jm, tm, js, f32([25.0]))
    ts = to_port(js)
    js, vj, sj = jax_run(jm, js, jnp.asarray([25.0]), 300)
    ts, vt, st = port_run(tm, ts, torch.tensor([25.0]), 300)
    assert_long_run(vt, vj, st, sj)
    t = float(ts["nt$t"][0, tm.type_index("AMPA")])
    assert 0.0 < t <= 1.0
    np.testing.assert_allclose(t, float(js["nt$t"][0, 0]), rtol=RTOL)


def test_dsl_ionotropic_monotonicity_matches_jax():
    """The five sweeps as one 55-neuron state over `RECEPTOR_STEPS` steps:
    the port's counts those of the JAX package, and monotone."""
    J, T = both(IONOTROPIC_NB, "IonoLIF")
    jm, tm = J(), T()
    assert tm.type_names == ("AMPA", "NMDA", "GABA")
    levels = np.linspace(0.0, 1.0, 11).astype(np.float32)
    n = 55
    js = jm.init_state(n, v=0.0, dt=1.0)
    mask = np.zeros((n, 3), bool)
    t_in = np.zeros((n, 3), np.float32)
    mg = np.full(n, 0.3, np.float32)
    mask[0:11, 0] = True
    t_in[0:11, 0] = levels
    mask[11:22, 1] = True
    t_in[11:22, 1] = levels
    mask[22:33, 1] = True
    t_in[22:33, 1] = 1.0
    mg[22:33] = levels
    mask[33:44, 0] = mask[33:44, 2] = True
    t_in[33:44, 0] = 1.0
    t_in[33:44, 2] = levels
    mask[44:55, 0] = mask[44:55, 1] = True
    t_in[44:55, 0] = levels
    t_in[44:55, 1] = 0.5
    js["rec$mask"] = jnp.asarray(mask)
    js["rec$NMDA$mg"] = jnp.asarray(mg)
    valid = np.ones((n, 3), bool)
    step_pair(jm, tm, js, np.zeros(n, np.float32), t_in, valid)
    ct, cj = counts_pair(jm, tm, js, np.zeros(n, np.float32), t_in, valid,
                         RECEPTOR_STEPS)
    assert np.abs(ct - cj).max() <= 1, (ct, cj)
    inc = lambda c: all(c[k] >= c[k - 1] for k in range(1, len(c)))
    dec = lambda c: all(c[k] <= c[k - 1] for k in range(1, len(c)))
    ampa, nmda, mg_c, gaba, joint = (ct[0:11], ct[11:22], ct[22:33],
                                     ct[33:44], ct[44:55])
    assert inc(ampa) and ampa[0] < ampa[-1], ampa
    assert inc(nmda) and nmda[0] < nmda[-1], nmda
    assert dec(mg_c) and mg_c[0] > mg_c[-1], mg_c
    assert dec(gaba) and gaba[0] > gaba[-1], gaba
    assert inc(joint) and (joint >= ampa).all(), (joint, ampa)


def _recall(counts, pattern, threshold):
    return float(((np.asarray(counts) >= threshold)
                  == np.asarray(pattern, bool).reshape(np.shape(counts))
                  ).mean())


def test_attractor_builders_match_jax():
    """The port's attractors, which the two attractor tests below build
    their patterns and weights from, against the JAX package's on the
    same patterns."""
    for seed in (100, 101, 102, 300, 301, 302):
        patterns = generate_random_patterns(7, 7, 1, 0.5, seed=seed)
        np.testing.assert_array_equal(
            patterns, jattractors.generate_random_patterns(7, 7, 1, 0.5,
                                                           seed=seed))
        np.testing.assert_array_equal(
            generate_hopfield_network(patterns),
            np.asarray(jattractors.generate_hopfield_network(patterns)))
        np.testing.assert_array_equal(
            generate_binary_hopfield_network(patterns, 1.0, 1.0, 0.5),
            np.asarray(jattractors.generate_binary_hopfield_network(
                patterns, 1.0, 1.0, 0.5)))
        np.testing.assert_array_equal(
            distort_pattern(patterns[0], 0.1, seed=seed),
            jattractors.distort_pattern(patterns[0], 0.1, seed=seed))


def test_dsl_izhikevich_attractor_bipolar_matches_jax():
    """A DSL Izhikevich lattice with bipolar Hopfield weights (a
    `DenseGraph`: the plain route), carried from the JAX package's lattice
    with ``convert.lattice_from(..., model=)``: the state key for key, the
    recall, and the spike counts of both."""
    J, T = both(DSL_IZHIKEVICH_NB, "AttractorIzhikevich")
    accuracies = []
    for trial in range(3):
        lat = snn.Lattice(J())
        lat.populate(7, 7, gap_conductance=10.0, v=-65.0, dt=1.0)
        patterns = generate_random_patterns(7, 7, 1, 0.5, seed=100 + trial)
        w = generate_hopfield_network(patterns)
        lat.set_graph(JDenseGraph(jnp.asarray(w),
                                  jnp.asarray(~np.eye(49, dtype=bool))))
        flat = jnp.asarray(np.asarray(distort_pattern(
            patterns[0], 0.1, seed=trial), bool).reshape(-1))
        lat.apply(lambda s: {**s, "v": jnp.where(flat, s["v_th"], s["c"])})
        port = lattice_from(lat, model=T(), device="cpu")
        assert set(port.state) == set(lat.state)
        for k in lat.state:
            np.testing.assert_array_equal(port.state[k].numpy(),
                                          np.asarray(lat.state[k]), err_msg=k)
        lat.grid_history = JSpikeHistory()
        lat.update_grid_history = True
        port.grid_history = SpikeHistory()
        port.update_grid_history = True
        lat.run_lattice(1000)
        port.run_lattice(1000)
        assert port._last_run_fused is False
        ct = np.asarray(port.grid_history.aggregate())
        cj = np.asarray(lat.grid_history.aggregate())
        np.testing.assert_array_equal(ct, cj)
        accuracies.append(_recall(ct, patterns[0], 5))
    assert sum(a > 0.9 for a in accuracies) >= 1, accuracies


def _binary_network(pkg, gen, trial, device=None):
    kw = {} if device is None else {"device": device}
    rng = np.random.default_rng(200 + trial)
    inh = pkg.Lattice(gen(), id=0, **kw)
    inh.populate(3, 3, gap_conductance=10.0, dt=1.0,
                 v=rng.uniform(-55.0, 30.0, 9).astype(np.float32))
    inh.connect(lambda x, y: x != y, lambda x, y: -1.5)
    exc = pkg.Lattice(gen(), id=1, **kw)
    exc.populate(5, 5, gap_conductance=10.0, v=-65.0, dt=1.0)
    patterns = generate_random_patterns(5, 5, 1, 0.5, seed=300 + trial)
    w = generate_binary_hopfield_network(patterns, 1.0, 1.0, 0.5)
    flat = np.asarray(distort_pattern(patterns[0], 0.1, seed=trial),
                      bool).reshape(-1)
    if device is None:
        exc.set_graph(JDenseGraph(jnp.asarray(w),
                                  jnp.asarray(~np.eye(25, dtype=bool))))
        exc.apply(lambda s: {**s, "v": jnp.where(jnp.asarray(flat),
                                                 s["v_th"], s["c"])})
        exc.grid_history = JSpikeHistory()
    else:
        exc.set_graph(snt.DenseGraph(torch.as_tensor(w, dtype=torch.float32),
                                     torch.as_tensor(~np.eye(25, dtype=bool))))
        exc.apply(lambda s: {**s, "v": torch.where(torch.as_tensor(flat),
                                                   s["v_th"], s["c"])})
        exc.grid_history = SpikeHistory()
    exc.update_grid_history = True
    net = pkg.LatticeNetwork.generate_network([inh, exc], [], **kw)
    net.connect(0, 1, lambda a, b: True, lambda a, b: -2.0)
    net.connect(1, 0, lambda a, b: True, lambda a, b: 1.0)
    return net, patterns[0]


def test_dsl_izhikevich_attractor_binary_network_matches_jax():
    """The binary Hopfield excitatory lattice and an inhibitory pool of DSL
    Izhikevich neurons in a `LatticeNetwork`, built through each package's
    own surface: the recall, and the port's spike counts against the JAX
    package's."""
    J, T = both(DSL_IZHIKEVICH_NB, "AttractorIzhikevich")
    accuracies = []
    for trial in range(3):
        jnet, pattern = _binary_network(snn, J, trial)
        tnet, _ = _binary_network(snt, T, trial, device="cpu")
        jnet.run_lattices(1000)
        tnet.run_lattices(1000)
        ct = np.asarray(tnet.get_lattice(1).grid_history.aggregate())
        cj = np.asarray(jnet.get_lattice(1).grid_history.aggregate())
        assert np.abs(ct - cj).max() <= 2, (ct, cj)
        accuracies.append(_recall(ct, pattern, 10))
    assert sum(accuracies) / 3 >= 0.85, accuracies

"""The chemical `LatticeNetwork` of the PyTorch port against the JAX package
on the CPU: `DopaGluGABAReceptors` and `DopaIzhikevich`, the plain route
against the JAX XLA structured runner on the configurations of
``tests/test_pallas_chem.py`` (every receptor and neurotransmitter
kinetics, both receptor families, dopamine modulation, electrical and
chemical synapses at once, STDP, a resampled chemical connection, a grid
history), the gate, Poisson statistics, and carrying chemical models and
networks across.

Tolerance: rtol 1e-5, atol 1e-4 on v, w, concentrations, gating values,
currents and modifiers over a 121-step call, the JAX package's own for its
chemical kernel against its XLA path; firing times and spikes equal.
PyTorch's exp and pow and XLA's differ in the last ulp, and the receptor
currents (up to ~1e3 at g 25, e 60) carry it.  One receptor update and one
set of currents agree to rtol 1e-6, atol 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.models.dopa import DopaIzhikevich as JDopa
from spiking_neural_networks_tpu.ops.receptors import (
    DopaGluGABAReceptors as JDopaRec)
from spiking_neural_networks_tpu_torch.convert import (
    lattice_from, network_from, state_from_numpy)
from torch_networks import both, chem_net

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
STEPS = 121                     # seven K = 16 calls and a remainder of 9
CHEM_KEYS = ("nt$t", "rec$r", "rec$current", "rec$r2", "rec$inh_modifier",
             "rec$nmda_modifier")
# the configurations of tests/test_pallas_chem.py, with the NT kinetics the
# JAX tests leave out (discrete), DopaGluGABA at every receptor kinetics
# with a dopamine source, and a resampled chemical connection
CONFIGS = {
    "approximate": dict(),
    "bounded": dict(rec="bounded", nt="bounded"),
    "destexhe": dict(rec="destexhe", nt="destexhe"),
    "exponential_decay": dict(rec="exponential_decay",
                              nt="exponential_decay"),
    "discrete": dict(rec="bounded", nt="discrete"),
    "dopamine-bounded": dict(family="dopaglugaba", rec="bounded",
                             nt="bounded", dopamine=True),
    "dopamine-approximate": dict(family="dopaglugaba", rec="approximate",
                                 nt="approximate", dopamine=True),
    "dopamine-destexhe": dict(family="dopaglugaba", rec="destexhe",
                              nt="destexhe", dopamine=True),
    "dopamine-exponential_decay": dict(family="dopaglugaba",
                                       rec="exponential_decay",
                                       nt="exponential_decay",
                                       dopamine=True),
    "electrical": dict(electrical=True),
    "stdp": dict(rec="bounded", nt="bounded", plastic=True),
    "history": dict(history=True),
    "resample": dict(resample=True),
}


def assert_chem_networks_match(t, j, rtol=RTOL, atol=ATOL):
    """Every lattice's and train's state of port network ``t`` against
    JAX network ``j``: the same keys, integers and spikes equal, floats
    within ``rtol``/``atol``."""
    assert t.internal_clock == j.internal_clock
    for lid, jl in j.lattices.items():
        tl = t.lattices[lid]
        assert set(tl.state) == set(jl.state)
        for k in ("v", "w") + CHEM_KEYS:
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
    for sid, js in j.spike_train_lattices.items():
        ts = t.spike_train_lattices[sid]
        for k in ("last_firing_time", "is_spiking"):
            np.testing.assert_array_equal(ts.state[k].numpy(),
                                          np.asarray(js.state[k]))
        np.testing.assert_allclose(ts.state["nt$t"].numpy(),
                                   np.asarray(js.state["nt$t"]), rtol=rtol,
                                   atol=atol)


# -- receptors and the model --------------------------------------------------


def _dopa_state(n, kinetics, seed):
    rng = np.random.default_rng(seed)
    s = JDopaRec(kinetics).init_fields(n)
    for k in ("rec$r", "rec$r2"):
        s[k] = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    s["rec$mask"] = rng.random((n, 3)) < 0.7
    s["rec$s_d1"] = rng.uniform(0, 0.5, n).astype(np.float32)
    s["rec$s_d2"] = rng.uniform(0, 0.5, n).astype(np.float32)
    nmda = rng.uniform(0.5, 1.0, n).astype(np.float32)
    nmda[::4] = 1.0                           # pow's exact case y == 1
    s["rec$nmda_modifier"] = nmda
    s["rec$inh_modifier"] = rng.uniform(0.5, 1.0, n).astype(np.float32)
    for k in list(s):
        if "r_max" in k or "alpha" in k or "beta" in k or "decay" in k:
            s[k] = (s[k] * rng.uniform(0.5, 1.5, s[k].shape)).astype(
                np.float32)
    s["dt"] = np.full(n, 0.1, np.float32)
    s["c_m"] = np.full(n, 100.0, np.float32)
    return s, rng


@pytest.mark.parametrize("kinetics", ["approximate", "bounded", "destexhe",
                                      "exponential_decay"])
def test_dopaglugaba_receptors_match_jax(kinetics):
    """`update_kinetics` (both gating slots, each with its own kinetics
    fields) and `set_currents` (the 3.57 block, ``nmda_r ** nmda_mod``
    with nmda_mod != 1, the modifiers rewritten after the currents)."""
    n = 64
    s, rng = _dopa_state(n, kinetics, 3)
    t_in = rng.uniform(0, 1.2, (n, 3)).astype(np.float32)
    valid = rng.random((n, 3)) < 0.8
    v = rng.uniform(-80, 30, n).astype(np.float32)
    jr, tr = JDopaRec(kinetics), snt.DopaGluGABAReceptors(kinetics)
    js = {k: jnp.asarray(x) for k, x in s.items()}
    ts = state_from_numpy(s, "cpu")
    jk = jr.update_kinetics(js, jnp.asarray(t_in), jnp.asarray(valid))
    tk = tr.update_kinetics(ts, torch.from_numpy(t_in),
                            torch.from_numpy(valid))
    assert set(tk) == set(jk) == {"rec$r", "rec$r2"}
    for k in jk:
        np.testing.assert_allclose(tk[k].numpy(), np.asarray(jk[k]),
                                   rtol=1e-6, atol=1e-5, err_msg=k)
    js.update(jk)
    ts.update(tk)
    jc = jr.set_currents(js, jnp.asarray(v))
    tc = tr.set_currents(ts, torch.from_numpy(v))
    assert set(tc) == set(jc)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6, atol=1e-5, err_msg=k)
    assert (np.asarray(jc["rec$nmda_modifier"]) != 1.0).any()
    ts.update(tc)
    js.update(jc)
    np.testing.assert_allclose(tr.receptor_dv(ts).numpy(),
                               np.asarray(jr.receptor_dv(js)), rtol=1e-6,
                               atol=1e-6)


def test_dopa_izhikevich_matches_jax():
    """`DopaIzhikevich`: its defaults and one chemical step."""
    assert snt.DopaIzhikevich.FIELDS == JDopa.FIELDS
    jm, tm = JDopa(), snt.DopaIzhikevich()
    assert isinstance(tm.receptors, snt.DopaGluGABAReceptors)
    assert (tm.nt_kinetics, tm.receptors.kinetics) == ("bounded", "bounded")
    n = 48
    s, rng = _dopa_state(n, "bounded", 5)
    host = jm.init_state_host(n)
    host.update({k: x for k, x in s.items() if k in host})
    host["v"] = rng.uniform(-70, 40, n).astype(np.float32)
    host["nt$t"] = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    host["nt$mask"] = rng.random((n, 3)) < 0.7
    host["is_spiking"] = rng.random(n) < 0.3
    t_in = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    valid = rng.random((n, 3)) < 0.8
    i = rng.uniform(-5, 5, n).astype(np.float32)
    js, jspk = jm.step({k: jnp.asarray(x) for k, x in host.items()},
                       jnp.asarray(i), jnp.asarray(t_in), jnp.asarray(valid))
    ts, tspk = tm.step(state_from_numpy(host, "cpu"), torch.from_numpy(i),
                       torch.from_numpy(t_in), torch.from_numpy(valid))
    np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk))
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-6, atol=1e-5, err_msg=k)


# -- the plain route ----------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_route_matches_jax_xla(name):
    """One 121-step `run_lattices` of the plain route (use_kernel=False)
    against the JAX XLA structured runner (use_pallas=False)."""
    j, t = both(lambda: chem_net(**CONFIGS[name]), False, False)
    j.run_lattices(STEPS)
    t.run_lattices(STEPS)
    assert j._last_run_fused is False and t._last_run_fused is False
    assert_chem_networks_match(t, j)
    assert t.lattices[0].state["rec$r"].max() > 0
    if name.startswith("dopamine") and name != "dopamine-exponential_decay":
        assert (t.lattices[1].state["rec$nmda_modifier"] != 1.0).any()
    if CONFIGS[name].get("history"):
        np.testing.assert_allclose(
            np.stack(t.lattices[0].grid_history.history),
            np.stack([np.asarray(x)
                      for x in j.lattices[0].grid_history.history]),
            rtol=RTOL, atol=ATOL)
    if CONFIGS[name].get("resample"):
        assert t.lattices[4].state["rec$r"].max() > 0


# -- the gate -----------------------------------------------------------------


def _route(build, use_kernel=True):
    j, t = both(build, True, use_kernel)
    t.run_lattices(2)
    j.run_lattices(2)
    return t._last_run_fused, bool(j._last_run_fused)


def test_gate_routes_as_jax_does():
    """Chemical networks take the chemical arm on both packages unless a
    model lacks c_m (LIF), the lattices' models differ, or a connection is
    resampled or dense; DopaIzhikevich and ALIF lattices take it."""
    def with_models(cls, **kw):
        def build():
            net = chem_net(**kw)
            for lat in net.lattices.values():
                m = lat.model
                lat.model = cls(nt_kinetics=m.nt_kinetics,
                                rec_kinetics=m.rec_kinetics,
                                receptors=m.receptors)
                fields = lat.model.init_state_host(lat.n)
                lat.state = {**{k: jnp.asarray(x) for k, x in fields.items()},
                             **{k: x for k, x in lat.state.items()
                                if k in fields}}
            return net
        return build

    def dense():
        net = chem_net()
        net.connect(0, 1, lambda x, y: (x[0] * 3 + y[1]) % 5 == 0,
                    lambda x, y: 0.1)
        return net

    cases = [(chem_net, ("chemical", False), True),
             (lambda: chem_net(history=True), ("chemical", True), True),
             (lambda: chem_net(family="dopaglugaba", rec="bounded",
                               nt="bounded", dopamine=True),
              ("chemical", False), True),
             (with_models(snn.AdaptiveLeakyIntegrateAndFire),
              ("chemical", False), True),
             (with_models(JDopa, family="dopaglugaba", rec="bounded",
                          nt="bounded"), ("chemical", False), True),
             (with_models(snn.LeakyIntegrateAndFire), False, False),
             (lambda: chem_net(resample=True), False, False),
             (dense, False, False)]
    for build, port_tag, jax_tag in cases:
        assert _route(build) == (port_tag, jax_tag)
    # lattices of two models (phase B steps each with lattice 0's)
    j, t = both(chem_net, True, True)
    j.lattices[1].model = snn.Izhikevich(nt_kinetics="bounded",
                                         rec_kinetics="approximate")
    t.lattices[1].model = snt.Izhikevich(nt_kinetics="bounded",
                                         rec_kinetics="approximate")
    j.run_lattices(2)
    t.run_lattices(2)
    assert j._last_run_fused is False and t._last_run_fused is False
    _, t = both(chem_net, True, None)
    t.run_lattices(2)
    assert t._last_run_fused is False       # auto: the kernel only on CUDA


def test_poisson_driven_networks_match_statistically():
    """Poisson trains draw other streams on each package and route, so
    the fraction of lattice 0 that fired and lattice 1's mean
    concentration agree statistically, as the JAX package's own test
    holds its kernel (10x10, 120 Hz, 400 steps)."""
    def build():
        return chem_net(train=snn.PoissonSpikeTrain(nt_kinetics="approximate"),
                        rows=10, cols=10)

    def stats(net):
        lft = net.lattices[0].state["last_firing_time"]
        t1 = net.lattices[1].state["nt$t"]
        return ((np.asarray(lft) >= 0).mean(), np.asarray(t1).mean())

    j, plain = both(build, False, False)
    t = network_from(j, "cpu")              # the twin's route
    t.use_kernel = True
    for net in (j, plain, t):
        net.run_lattices(400)
    assert t._last_run_fused == ("chemical", False)
    fired, conc = zip(*(stats(net) for net in (j, plain, t)))
    assert min(fired) > 0.2
    assert max(fired) - min(fired) < 0.25
    assert max(conc) == pytest.approx(min(conc), rel=0.5, abs=1e-3)


# -- carrying across ----------------------------------------------------------


def test_convert_carries_receptor_systems():
    """`lattice_from` rebuilds a JAX lattice's model with its receptor
    system (family and kinetics) and finds `DopaIzhikevich`; every state
    key and value carries across."""
    jlats = []
    m = snn.Izhikevich(nt_kinetics="exponential_decay",
                       rec_kinetics="destexhe",
                       receptors=JDopaRec("destexhe"))
    jlats.append(snn.Lattice(m, id=0))
    jlats.append(snn.Lattice(JDopa(), id=1))
    jlats.append(snn.Lattice(JDopa(nt_kinetics="discrete",
                                   rec_kinetics="approximate"), id=2))
    for jl in jlats:
        jl.populate(5, 6, gap_conductance=10.0)
        jl.connect_stencil(radius=1.5, keep_prob=0.8, seed=jl.id)
        s = jl.model.insert_receptor(jl.state, "Glutamate",
                                     **{"r2$" + k: 2.0 for k in
                                        ("alpha",) if jl.id == 0})
        s = jl.model.insert_receptor(s, "Dopamine", s_d2=0.05)
        jl.state = dict(jl.model.insert_neurotransmitter(s, "GABA"))
        t = lattice_from(jl, device="cpu")
        assert type(t.model).__name__ == type(jl.model).__name__
        assert type(t.model.receptors) is snt.DopaGluGABAReceptors
        assert t.model.receptors.kinetics == jl.model.receptors.kinetics
        assert t.model.nt_kinetics == jl.model.nt_kinetics
        assert set(t.state) == set(jl.state)
        for k, x in jl.state.items():
            np.testing.assert_array_equal(t.state[k].numpy(), np.asarray(x),
                                          err_msg=k)
    assert float(jlats[1].state["rec$s_d2"][0]) == pytest.approx(0.05)
    jhh = snn.Lattice(snn.HodgkinHuxley("approximate", "approximate"))
    jhh.populate(3, 3)
    hh = lattice_from(jhh, device="cpu")
    assert type(hh.model.receptors) is snt.IonotropicReceptors
    assert hh.model.receptors.kinetics == "approximate"


def test_network_from_carries_chemical_networks():
    j = chem_net(family="dopaglugaba", rec="bounded", nt="bounded",
                 dopamine=True)
    j.run_lattices(5)
    t = network_from(j, "cpu")
    assert t.chemical_synapse and not t.electrical_synapse
    assert t.internal_clock == j.internal_clock == 5
    for lid, jl in j.lattices.items():
        tl = t.lattices[lid]
        assert type(tl.model.receptors) is snt.DopaGluGABAReceptors
        assert set(tl.state) == set(jl.state)
        for k, x in jl.state.items():
            np.testing.assert_array_equal(tl.state[k].numpy(), np.asarray(x),
                                          err_msg=k)
    t.use_kernel = True
    t.run_lattices(3)
    assert t._last_run_fused == ("chemical", False)

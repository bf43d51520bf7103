"""The Hodgkin-Huxley chemical slice of the PyTorch port against the JAX
package on the CPU: the ion channels, peak detection and one
`HodgkinHuxley.step`, the chemical gathers, the plain route of the HH
lattice and of a chemical Izhikevich lattice against the JAX XLA path,
routing with a grid history, and carrying an HH lattice across.

Tolerances: one step and one gather agree to rtol 1e-6, atol 1e-5 (the
same ops, rounded alike except where XLA's exp and PyTorch's differ in the
last ulp); 100-step runs to rtol and atol 1e-5 with firing times and
was_increasing equal, except one case that ends mid-upstroke (1e-4, see
`test_plain_route_matches_jax_xla`).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.models import ion_channels as jch
from spiking_neural_networks_tpu.models.base import NeuronModel as JModel
from spiking_neural_networks_tpu.ops import graph as jg
from spiking_neural_networks_tpu_torch.convert import (
    lattice_from, state_from_numpy)
from spiking_neural_networks_tpu_torch.models import ion_channels as tch
from spiking_neural_networks_tpu_torch.models.base import NeuronModel
from spiking_neural_networks_tpu_torch.ops import hh_kernels
from torch_lattices import assert_hh_match, jax_hh_lattice

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _hh_state(n, seed, nt="destexhe", rec="destexhe"):
    """A host HH state with all three receptors and neurotransmitters,
    random v across the HH range, gates, concentrations and flags."""
    rng = np.random.default_rng(seed)
    jm = snn.HodgkinHuxley(nt, rec)
    s = jm.init_state_host(n)
    s["v"] = rng.uniform(-70, 40, n).astype(np.float32)
    for k in ("na$m_state", "na$h_state", "k$n_state"):
        s[k] = rng.uniform(0, 1, n).astype(np.float32)
    s["was_increasing"] = rng.random(n) < 0.5
    s["is_spiking"] = rng.random(n) < 0.3
    s["nt$t"] = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    s["rec$r"] = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    s["rec$current"] = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    s["nt$mask"] = rng.random((n, 3)) < 0.8
    s["rec$mask"] = rng.random((n, 3)) < 0.8
    return s, rng


# -- models -------------------------------------------------------------------


def test_channels_and_peak_detection_match_jax():
    s, rng = _hh_state(200, 1)
    v = rng.uniform(-80, 50, 200).astype(np.float32)
    js = {k: jnp.asarray(x) for k, x in s.items()}
    ts = state_from_numpy(s, "cpu")
    jv, tv = jnp.asarray(v), torch.from_numpy(v)
    for jout, tout in ((jch.na_channel_update(js, jv, js["dt"]),
                        tch.na_channel_update(ts, tv, ts["dt"])),
                       (jch.k_channel_update(js, jv, js["dt"]),
                        tch.k_channel_update(ts, tv, ts["dt"])),
                       (jch.k_leak_channel_update(js, jv),
                        tch.k_leak_channel_update(ts, tv))):
        assert set(jout) == set(tout)
        for k in jout:
            _close(tout[k], jout[k], msg=k)
    a, b = (rng.uniform(0.1, 2, 50).astype(np.float32) for _ in range(2))
    _close(tch.gate_init_state(torch.from_numpy(a), torch.from_numpy(b)),
           jch.gate_init_state(jnp.asarray(a), jnp.asarray(b)))
    last = v + rng.uniform(-1, 1, 200).astype(np.float32)
    jst, jspk = JModel._handle_peak_detection({**js, "v": jv},
                                              jnp.asarray(last))
    tst, tspk = NeuronModel._handle_peak_detection({**ts, "v": tv},
                                                   torch.from_numpy(last))
    np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk))
    np.testing.assert_array_equal(tst["was_increasing"].numpy(),
                                  np.asarray(jst["was_increasing"]))
    assert tspk.any() and not tspk.all()


@pytest.mark.parametrize("nt,rec", [("destexhe", "destexhe"),
                                    ("approximate", "approximate")])
@pytest.mark.parametrize("chemical", [True, False])
def test_hh_step_matches_jax(nt, rec, chemical):
    """One step from a random state, with and without neurotransmitter
    input (without it the ligand current reads the stored receptor
    currents, as in the JAX package)."""
    n = 300
    s, rng = _hh_state(n, 2, nt, rec)
    i = rng.uniform(-20, 20, n).astype(np.float32)
    t_in = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    valid = rng.random((n, 3)) < 0.7
    jm, tm = snn.HodgkinHuxley(nt, rec), snt.HodgkinHuxley(nt, rec)
    js = {k: jnp.asarray(x) for k, x in s.items()}
    ts = state_from_numpy(s, "cpu")
    if chemical:
        jout, jspk = jm.step(js, jnp.asarray(i), jnp.asarray(t_in),
                             jnp.asarray(valid))
        tout, tspk = tm.step(ts, torch.from_numpy(i), torch.from_numpy(t_in),
                             torch.from_numpy(valid))
    else:
        jout, jspk = jm.step(js, jnp.asarray(i))
        tout, tspk = tm.step(ts, torch.from_numpy(i))
    np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk))
    assert set(tout) == set(jout)
    for k in jout:
        if jout[k].dtype in (jnp.int32, jnp.bool_):
            np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                          err_msg=k)
        else:
            _close(tout[k], jout[k], msg=k)
    assert tspk.any()


# -- gathers ------------------------------------------------------------------


def test_stencil_gather_chemical_matches_jax():
    rows, cols = 12, 10
    rng = np.random.default_rng(3)
    jgr = jg.StencilGraph.build(rows, cols, jg.radius_offsets(2.0),
                                keep_prob=0.7, seed=4,
                                weight_fn=lambda dr, dc, rr, cc:
                                rng.uniform(0.2, 1.8, rr.shape))
    tgr = snt.StencilGraph.build(rows, cols, jg.radius_offsets(2.0),
                                 keep_prob=0.7, seed=4, device="cpu",
                                 weight_fn=lambda dr, dc, rr, cc:
                                 np.asarray(jgr.weights)[
                                     jgr.offsets.index((dr, dc))])
    np.testing.assert_array_equal(tgr.weights.numpy(), np.asarray(jgr.weights))
    n = rows * cols
    t = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    m = (rng.random((n, 3)) < 0.6).astype(np.float32)
    jt, jv = jgr.gather_chemical(jnp.asarray(t), jnp.asarray(m))
    tt, tv = tgr.gather_chemical(torch.from_numpy(t), torch.from_numpy(m))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.any() and not tv.all()


def test_sparse_gather_chemical():
    """The zero-edge default of a populated lattice gives no input; a COO
    graph matches the JAX package."""
    e = snt.SparseGraph.empty(6, device="cpu")
    t, valid = e.gather_chemical(torch.ones(6, 3), torch.ones(6, 3))
    assert t.shape == (6, 3) and not t.any() and not valid.any()
    rng = np.random.default_rng(5)
    src, dst = rng.integers(0, 8, 20), rng.integers(0, 8, 20)
    w = rng.uniform(0.5, 1.5, 20).astype(np.float32)
    jsg = jg.SparseGraph.from_arrays(src, dst, w, 8)
    tsg = snt.SparseGraph(torch.from_numpy(np.asarray(jsg.src, np.int64)),
                          torch.from_numpy(np.asarray(jsg.dst, np.int64)),
                          torch.from_numpy(np.array(jsg.weights)), 8, 8)
    tc = rng.uniform(0, 1, (8, 3)).astype(np.float32)
    m = (rng.random((8, 3)) < 0.7).astype(np.float32)
    jt, jv = jsg.gather_chemical(jnp.asarray(tc), jnp.asarray(m))
    tt, tv = tsg.gather_chemical(torch.from_numpy(tc), torch.from_numpy(m))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# -- the plain route against the JAX XLA path --------------------------------


@pytest.mark.parametrize("plastic,electrical,kinetics,tol", [
    (True, True, "destexhe", 1e-5), (False, True, "destexhe", 1e-5),
    (False, False, "destexhe", 1e-4), (False, True, "approximate", 1e-5)])
def test_plain_route_matches_jax_xla(plastic, electrical, kinetics, tol):
    """100 steps of the JAX package's HH test lattice on both XLA-order
    paths; neurons fire.  Without gap junctions one neuron is mid-upstroke
    at step 100, where the last-ulp difference between PyTorch's exp and
    XLA's in its gates moves v by 7.6e-5 mV: that case holds 1e-4."""
    j = jax_hh_lattice(plastic=plastic, electrical=electrical, nt=kinetics,
                       rec=kinetics)
    t = lattice_from(j, device="cpu")
    t.use_kernel = False
    j.run_lattice(100)
    t.run_lattice(100)
    assert t._last_run_fused is False and j._last_run_fused is False
    assert_hh_match(t, j, tol, tol)
    assert (t.state["last_firing_time"].numpy() >= 0).any()


def test_chemical_izhikevich_plain_route_matches_jax():
    """The chemical plain route serves the IF models too: an Izhikevich
    lattice with AMPA and GABA, approximate kinetics, 100 steps."""
    j = snn.Lattice(snn.Izhikevich())
    j.populate(12, 10, gap_conductance=10.0)
    s = j.state
    for name in ("AMPA", "GABA"):
        s = j.model.insert_receptor(s, name)
        s = j.model.insert_neurotransmitter(s, name)
    j.state = s
    j.connect_stencil(radius=2.0, keep_prob=0.8, seed=6)
    j.chemical_synapse = True
    # v0 across the threshold: neurons fire, release and drive receptors
    v0 = np.random.default_rng(7).uniform(-65, 40, 120).astype(np.float32)
    j.apply(lambda st: {**st, "v": jnp.asarray(v0)})
    j.use_pallas = False
    t = lattice_from(j, device="cpu")
    t.use_kernel = None
    j.run_lattice(100)
    t.run_lattice(100)
    assert t._last_run_fused is False
    for k in ("v", "w", "nt$t", "rec$r", "rec$current"):
        _close(t.state[k], j.state[k], 1e-5, 1e-5, k)
    np.testing.assert_array_equal(t.state["last_firing_time"].numpy(),
                                  np.asarray(j.state["last_firing_time"]))
    assert (t.state["last_firing_time"].numpy() >= 0).any()
    assert float(t.state["rec$current"].abs().max()) > 0


def test_grid_history_takes_the_plain_route():
    """The HH kernel keeps no history: with a grid history on, the
    lattice takes the plain route even when the kernel is asked for, and
    its history equals the plain route's."""
    def run(use_kernel):
        t = lattice_from(jax_hh_lattice(plastic=False), device="cpu")
        t.use_kernel = use_kernel
        t.update_grid_history = True
        t.run_lattice(30)
        assert t._last_run_fused is False
        return np.stack(t.grid_history.history)

    np.testing.assert_array_equal(run(True), run(False))
    t = lattice_from(jax_hh_lattice(plastic=False), device="cpu")
    t.use_kernel = True
    t.run_lattice(5)
    assert t._last_run_fused == "hh"


def test_lattice_from_carries_an_hh_lattice():
    """The model (class and kinetics), every (N,) and (N, 3) field, the
    graph, the STDP parameters and the clock."""
    j = jax_hh_lattice(8, 6, plastic=True, nt="approximate", rec="destexhe")
    j.plasticity = snn.STDP(a_plus=1.5, tau_minus=3.0)
    j.run_lattice(3)
    t = lattice_from(j, device="cpu")
    assert type(t.model) is snt.HodgkinHuxley
    assert (t.model.nt_kinetics, t.model.rec_kinetics) == \
        ("approximate", "destexhe")
    assert t.model.receptors.kinetics == "destexhe"
    assert set(t.state) == set(j.state)
    for k, x in j.state.items():
        np.testing.assert_array_equal(t.state[k].numpy(), np.asarray(x),
                                      err_msg=k)
        assert t.state[k].numpy().dtype == np.asarray(x).dtype
    for name in ("weights", "mask", "in_deg"):
        np.testing.assert_array_equal(getattr(t.graph, name).numpy(),
                                      np.asarray(getattr(j.graph, name)))
    assert t.graph.offsets == tuple(map(tuple, j.graph.offsets))
    assert t.plasticity.params == {k: float(v) for k, v in
                                   j.plasticity.params.items()}
    assert t.internal_clock == 3 and t.chemical_synapse and t.do_plasticity
    assert hh_kernels.supports(t.model, t.graph, t.chemical_synapse,
                               t.do_plasticity, t.plasticity)


def test_rate_singularities_take_their_limits():
    """At v = -40 and -55 mV exactly the m and n activation rates are 0 / 0:
    the JAX package's channels return NaN there, and gap junctions spread
    it (the kernel's twin with the JAX package's formulas, on a 512^2
    firing lattice, meets v = -40.0 at step 31 and is all NaN by step
    512).  The port's plain route and the kernel's twin take the
    rates' limits (1.0 and 0.1); one ulp away, and elsewhere, they agree
    with the JAX package."""
    v = np.array([-40.0, -55.0, np.nextafter(np.float32(-40), np.float32(0)),
                  np.nextafter(np.float32(-55), np.float32(-99)), -30.0],
                 np.float32)
    n = len(v)
    s, _ = _hh_state(n, 6)
    js = {k: jnp.asarray(x) for k, x in s.items()}
    ts = state_from_numpy(s, "cpu")
    jna = jch.na_channel_update(js, jnp.asarray(v), js["dt"])
    jk = jch.k_channel_update(js, jnp.asarray(v), js["dt"])
    tna = tch.na_channel_update(ts, torch.from_numpy(v), ts["dt"])
    tk = tch.k_channel_update(ts, torch.from_numpy(v), ts["dt"])
    assert np.isnan(np.asarray(jna["na$m_state"])[0])
    assert np.isnan(np.asarray(jk["k$n_state"])[1])
    m0, n0, dt = s["na$m_state"], s["k$n_state"], s["dt"]
    beta_m = np.float32(4.0) * np.exp(np.float32(-25.0 / 18.0),
                                      dtype=np.float32)
    want_m = m0[0] + dt[0] * (np.float32(1.0) * (1 - m0[0]) - beta_m * m0[0])
    beta_n = np.float32(0.125) * np.exp(np.float32(-10.0 / 80.0),
                                        dtype=np.float32)
    want_n = n0[1] + dt[1] * (np.float32(0.1) * (1 - n0[1]) - beta_n * n0[1])
    np.testing.assert_allclose(tna["na$m_state"][0].item(), want_m, rtol=1e-6)
    np.testing.assert_allclose(tk["k$n_state"][1].item(), want_n, rtol=1e-6)
    for key, t, j in (("na$m_state", tna, jna), ("k$n_state", tk, jk)):
        assert torch.isfinite(t[key]).all()
        _close(t[key][2:], np.asarray(j[key])[2:], msg=key)
    # the kernel's twin takes the same limits
    st = dict(ts, v=torch.from_numpy(v[:4].copy()),
              **{k: ts[k][:4] for k in ts if k != "v"})
    g = snt.StencilGraph.build(2, 2, ((0, 1),), device="cpu")
    out, _ = hh_kernels.hh_steps_reference(
        st, g.weights, g.mask, g.in_deg, g.offsets, 0, 1, False, "destexhe",
        "destexhe")
    np.testing.assert_allclose(out["na$m_state"].numpy(),
                               tna["na$m_state"][:4].numpy(), rtol=1e-6)
    np.testing.assert_allclose(out["k$n_state"].numpy(),
                               tk["k$n_state"][:4].numpy(), rtol=1e-6)


def test_jax_rate_expressions_are_nan_at_the_singularities():
    """The port's intended semantics at the HH rates' 0 / 0 points: the JAX
    package's own m and n rate expressions (`na_channel_update`,
    `k_channel_update`, read as the gate after one step of dt 1 from 0,
    which is the rate alpha) are NaN at v = -40 and -55 mV; the port's
    are their limits, 1.0 and 0.1, and equal the JAX package's at every
    other v of a sweep around the two points."""
    v = np.array([-40.0, -55.0], np.float32)
    sweep = np.concatenate([np.linspace(-41, -39, 41), np.linspace(-56, -54,
                                                                  41)])
    sweep = sweep[(sweep != -40.0) & (sweep != -55.0)].astype(np.float32)
    for volts, singular in ((v, True), (sweep, False)):
        n = len(volts)
        s = {"na$m_state": np.zeros(n, np.float32),
             "na$h_state": np.zeros(n, np.float32),
             "k$n_state": np.zeros(n, np.float32),
             "dt": np.ones(n, np.float32)}
        s.update({k: np.full(n, x, np.float32) for k, x in
                  {**jch.NA_DEFAULTS, **jch.K_DEFAULTS}.items()
                  if k not in s})
        js = {k: jnp.asarray(x) for k, x in s.items()}
        ts = state_from_numpy(s, "cpu")
        j_m = np.asarray(jch.na_channel_update(js, jnp.asarray(volts),
                                               js["dt"])["na$m_state"])
        j_n = np.asarray(jch.k_channel_update(js, jnp.asarray(volts),
                                              js["dt"])["k$n_state"])
        t_m = tch.na_channel_update(ts, torch.from_numpy(volts),
                                    ts["dt"])["na$m_state"].numpy()
        t_n = tch.k_channel_update(ts, torch.from_numpy(volts),
                                   ts["dt"])["k$n_state"].numpy()
        if singular:
            assert np.isnan(j_m[0]) and np.isnan(j_n[1])
            assert t_m[0] == np.float32(1.0) and t_n[1] == np.float32(0.1)
        else:
            assert np.isfinite(j_m).all() and np.isfinite(j_n).all()
            np.testing.assert_allclose(t_m, j_m, rtol=1e-5)
            np.testing.assert_allclose(t_n, j_n, rtol=1e-5)

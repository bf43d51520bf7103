"""Builders shared by the plasticity and Hodgkin-Huxley tests of the
PyTorch port: one JAX lattice made from a NumPy seed, carried into the port
with `convert`, and the comparison of the two after a run."""

import numpy as np
import jax.numpy as jnp

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu_torch.convert import (
    lattice_from, reward_lattice_from)

MODELS = {"izhikevich": (snn.Izhikevich, snt.Izhikevich),
          "alif": (snn.AdaptiveLeakyIntegrateAndFire,
                   snt.AdaptiveLeakyIntegrateAndFire),
          "lif": (snn.LeakyIntegrateAndFire, snt.LeakyIntegrateAndFire)}
# R-STDP parameters that keep weights, traces and dopamine bounded over a
# test run while exercising the trace decay (exp(-dt / tau_c) = 0.82)
RSTDP = dict(tau_d=2.0, tau_c=0.5, a_plus=0.02, a_minus=0.02)


def jax_lattice(model, kind, rows=12, cols=10, seed=3, use_pallas=False):
    """A JAX lattice of ``model``: kind ``plastic`` is a `Lattice` with
    STDP, ``mod`` and ``plain`` a `RewardModulatedLattice` with and without
    modulation.  Radius 2, keep 0.8, random weights, v0 across the
    threshold, 30% of the neurons with a past firing time, clock 3, and for
    the reward lattice random traces and dopamine 0.3."""
    rng = np.random.default_rng(seed)
    jcls = MODELS[model][0]
    lat = snn.Lattice(jcls()) if kind == "plastic" \
        else snn.RewardModulatedLattice(jcls())
    lat.populate(rows, cols, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=seed + 2,
                        weight_fn=lambda dr, dc, rr, cc:
                        rng.uniform(0.5, 1.5, rr.shape))
    n = rows * cols
    lo, hi = (-60.0, 50.0) if model == "izhikevich" else (-75.0, -50.0)
    v0 = rng.uniform(lo, hi, n).astype(np.float32)
    lft0 = np.where(rng.random(n) < 0.3, rng.integers(0, 3, n),
                    -1).astype(np.int32)
    lat.apply(lambda s: {**s, "v": jnp.asarray(v0),
                         "last_firing_time": jnp.asarray(lft0)})
    lat.internal_clock = 3
    if kind == "plastic":
        lat.do_plasticity = True
    else:
        shp = lat.graph.weights.shape
        lat.trace = dict(
            c=jnp.asarray(rng.uniform(-0.5, 0.5, shp).astype(np.float32)),
            dw=jnp.asarray(rng.uniform(-0.1, 0.1, shp).astype(np.float32)),
            counter=jnp.asarray(rng.integers(0, 2, shp).astype(np.int32)))
        lat.dopamine = 0.3
        lat.do_modulation = kind == "mod"
        lat.reward_modulator = snn.RewardModulatedSTDP(**RSTDP)
    lat.use_pallas = use_pallas
    return lat


def port_of(jlat, model, use_kernel):
    """The port's lattice carrying ``jlat``'s numbers."""
    tcls = MODELS[model][1]
    lat = lattice_from(jlat, tcls(), "cpu") \
        if isinstance(jlat, snn.Lattice) \
        else reward_lattice_from(jlat, tcls(), "cpu")
    lat.use_kernel = use_kernel
    return lat


def assert_lattices_match(t, j, rtol, atol):
    """State, weights, traces and dopamine of port lattice ``t`` against
    JAX lattice ``j``: integers and spikes equal, floats within
    ``rtol``/``atol``."""
    for k in ("v", "w", "refractory_count"):
        if k in j.state:
            np.testing.assert_allclose(t.state[k].numpy(),
                                       np.asarray(j.state[k]), rtol=rtol,
                                       atol=atol, err_msg=k)
    assert set(t.state) == set(j.state)
    for k in ("last_firing_time", "is_spiking"):
        np.testing.assert_array_equal(t.state[k].numpy(),
                                      np.asarray(j.state[k]), err_msg=k)
    np.testing.assert_allclose(t.graph.weights.numpy(),
                               np.asarray(j.graph.weights), rtol=rtol,
                               atol=atol, err_msg="weights")
    if hasattr(j, "trace"):
        for k in ("c", "dw"):
            np.testing.assert_allclose(t.trace[k].numpy(),
                                       np.asarray(j.trace[k]), rtol=rtol,
                                       atol=atol, err_msg=k)
        np.testing.assert_array_equal(t.trace["counter"].numpy(),
                                      np.asarray(j.trace["counter"]))
        assert abs(t.dopamine - j.dopamine) <= rtol * max(1.0, abs(j.dopamine))
    assert t.internal_clock == j.internal_clock


# the fields of an HH lattice compared after a run, beside lft and
# was_increasing
HH_KEYS = ("v", "na$m_state", "na$h_state", "k$n_state", "nt$t", "rec$r",
           "rec$current", "na$current", "k$current", "kleak$current")


def jax_hh_lattice(rows=16, cols=16, plastic=True, electrical=True,
                   nt="destexhe", rec="destexhe", seed=9, use_pallas=False):
    """The JAX package's HH chemical lattice of its kernel tests
    (tests/test_pallas_hh.py): AMPA, NMDA and GABA receptors and
    neurotransmitters, gap 10, radius 2, keep 0.8, graph seed 11, STDP when
    ``plastic``, equilibrium gates (m 0.05, h 0.6, n 0.32) and v0 uniform
    in [-65, -20) from ``default_rng(seed)``, so that it fires within ~100
    steps."""
    lat = snn.Lattice(snn.HodgkinHuxley(nt_kinetics=nt, rec_kinetics=rec))
    lat.populate(rows, cols, gap_conductance=10.0)
    s = lat.state
    for t in ("AMPA", "NMDA", "GABA"):
        s = lat.model.insert_receptor(s, t)
        s = lat.model.insert_neurotransmitter(s, t)
    lat.state = s
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=11)
    lat.electrical_synapse = electrical
    lat.chemical_synapse = True
    lat.do_plasticity = plastic
    if plastic:
        lat.plasticity = snn.STDP()
    n = rows * cols
    v0 = np.random.default_rng(seed).uniform(-65, -20, n)
    lat.apply(lambda st: {
        **st, "v": jnp.asarray(v0, jnp.float32),
        "na$m_state": jnp.full(n, 0.05, jnp.float32),
        "na$h_state": jnp.full(n, 0.6, jnp.float32),
        "k$n_state": jnp.full(n, 0.32, jnp.float32)})
    lat.use_pallas = use_pallas
    return lat


def assert_hh_match(t, j, rtol, atol):
    """HH state and weights of port lattice ``t`` against JAX lattice
    ``j``: lft and was_increasing equal, floats within ``rtol``/``atol``."""
    for k in HH_KEYS:
        np.testing.assert_allclose(t.state[k].numpy(), np.asarray(j.state[k]),
                                   rtol=rtol, atol=atol, err_msg=k)
    for k in ("last_firing_time", "was_increasing", "is_spiking"):
        np.testing.assert_array_equal(t.state[k].numpy(),
                                      np.asarray(j.state[k]), err_msg=k)
    np.testing.assert_allclose(t.graph.weights.numpy(),
                               np.asarray(j.graph.weights), rtol=rtol,
                               atol=atol, err_msg="weights")
    assert set(t.state) == set(j.state)
    assert t.internal_clock == j.internal_clock

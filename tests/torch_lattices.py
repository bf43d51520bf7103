"""Builders shared by the plasticity and Hodgkin-Huxley tests of the
PyTorch port: one JAX lattice made from a NumPy seed, carried into the port
with `convert`, and the comparison of the two after a run."""

import numpy as np
import jax.numpy as jnp
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu_torch.convert import (
    lattice_from, reward_lattice_from)
from spiking_neural_networks_tpu_torch.ops import reward_kernels as rk

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


# -- the fused schedule's inputs (tests/test_torch_plasticity_schedule.py and
# the cuda tests) --------------------------------------------------------------


def bits_equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(bits_equal, a, b))
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def schedule_inputs(kind, model, with_reward, rows=10, cols=13, seed=0,
                    n_rewards=37, device="cpu", offsets=None):
    """One call's tensors: random state, weights and traces from
    ``seed`` on a radius-2, 80%-keep stencil; a tenth of the weights
    -0.0, counters of 0, 1 and 2, dw +0.0 and -0.0 in places, masked
    slots whose neighbour is off the grid; ``cols`` not a multiple of 4;
    ``n_rewards`` rewards (with a reward); on ``device``; radius 2 unless
    ``offsets`` are given."""
    rng = np.random.default_rng(seed)
    shape = (rows, cols)
    g = snt.StencilGraph.build(rows, cols,
                               offsets or snt.radius_offsets(2.0),
                               keep_prob=0.8, seed=seed + 1,
                               weight_fn=lambda dr, dc, rr, cc:
                               rng.uniform(0.5, 1.5, rr.shape),
                               device=device)
    cls = {"izhikevich": snt.Izhikevich,
           "alif": snt.AdaptiveLeakyIntegrateAndFire,
           "lif": snt.LeakyIntegrateAndFire}[model]
    n_off = len(g.offsets)

    def f32(lo, hi, shp=shape):
        return torch.from_numpy(
            rng.uniform(lo, hi, shp).astype(np.float32)).to(device)

    def some(frac):
        return torch.from_numpy(rng.random((n_off, *shape)) < frac).to(device)

    weights = g.weights.clone()
    weights[some(0.1)] = -0.0
    dw = f32(-0.1, 0.1, (n_off, *shape))
    dw[some(0.2)] = 0.0
    dw[some(0.1)] = -0.0
    izh = model == "izhikevich"
    return dict(
        spec=rk.LatSpec(kind, model, g.offsets, True, with_reward),
        v=f32(-60, 50) if izh else f32(-75, -50),
        w=f32(20, 40) if izh else f32(-5, 5) if model == "alif"
        else torch.zeros(shape, device=device),
        lft=torch.from_numpy(np.where(rng.random(shape) < 0.3,
                                      rng.integers(90, 100, shape),
                                      -1).astype(np.int32)).to(device),
        refr=None if izh else torch.from_numpy(
            rng.integers(0, 4, shape).astype(np.float32)).to(device),
        weights=weights, mask=g.mask | some(0.05), in_deg=g.in_deg,
        params={k: torch.full(shape, float(cls.FIELDS[k]), device=device)
                for k in rk.MODEL_PARAM_KEYS[model]},
        traces=(f32(-0.5, 0.5, (n_off, *shape)), dw, torch.from_numpy(
            rng.integers(0, 3, (n_off, *shape)).astype(np.int32)).to(device))
        if kind == "mod" else None,
        dopamine=torch.tensor(0.3, device=device),
        rule=snt.STDP().params if kind == "plastic"
        else snt.RewardModulatedSTDP(**RSTDP).params,
        rewards=np.linspace(-0.1, 0.2, n_rewards).astype(np.float32)
        if with_reward else None,
        clock0=100)


def hh_schedule_inputs(rows=10, cols=13, seed=0, nt="destexhe",
                       rec="destexhe", device="cpu"):
    """An HH call's tensors in the firing form of random state (v
    across the range, random gates, flags, concentrations and past firing
    times), a tenth of the weights -0.0; on ``device``."""
    n = rows * cols
    rng = np.random.default_rng(seed)
    g = snt.StencilGraph.build(rows, cols, snt.radius_offsets(2.0),
                               keep_prob=0.8, seed=seed + 1,
                               weight_fn=lambda dr, dc, rr, cc:
                               rng.uniform(0.5, 1.5, rr.shape),
                               device=device)
    st = snt.HodgkinHuxley(nt, rec).init_state_host(n)

    def f(lo, hi, shp=(n,)):
        return rng.uniform(lo, hi, shp).astype(np.float32)

    st.update({"v": f(-70, 40), "na$m_state": f(0, 1),
               "na$h_state": f(0, 1), "k$n_state": f(0, 1),
               "was_increasing": rng.random(n) < 0.5,
               "is_spiking": rng.random(n) < 0.2,
               "last_firing_time": np.where(rng.random(n) < 0.3,
                                            rng.integers(90, 100, n),
                                            -1).astype(np.int32),
               "nt$t": f(0, 1, (n, 3)), "rec$r": f(0, 1, (n, 3))})
    weights = g.weights.clone()
    weights[torch.from_numpy(rng.random(tuple(weights.shape)) < 0.1)
            .to(device)] = -0.0
    return dict(state={k: torch.from_numpy(np.ascontiguousarray(x))
                       .to(device) for k, x in st.items()},
                weights=weights, mask=g.mask, in_deg=g.in_deg,
                offsets=g.offsets, clock0=100, electrical=True, nt_kind=nt,
                rec_kind=rec, rule=snt.STDP().params)

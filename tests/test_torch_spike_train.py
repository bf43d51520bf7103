"""Spike trains of the PyTorch port against the JAX package: the
deterministic trains step for step, the refractoriness effects within an
ulp, Poisson firing fractions within a stated bound of their chance, and
the standalone `SpikeTrainLattice` runner.

Tolerances: Rate and Preset trains (and Poisson trains whose chances are 0
or 1) are equal step for step: spikes, firing times and counters exactly,
floats within rtol 1e-6.  The effects agree within one float32 ulp of the
result plus ``(1 + 3|x|)`` ulps of the amplitude term ``a * exp(x)``: XLA
folds the exponent's ``-1 / (k / dt)`` into ``-dt / k`` (one rounding for
two), so the exponent x differs by up to 1.5 ulp, which exp scales by |x|,
and the two backends' exp differ by an ulp.  Poisson streams differ by
design, so a firing fraction over 4096 trains x 200 steps must lie within
0.002 of its chance (eight standard deviations at a chance of 0.05).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.models import spike_train as jst
from spiking_neural_networks_tpu_torch.convert import spike_train_lattice_from
from spiking_neural_networks_tpu_torch.models import spike_train as tst

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _states(jmodel, tmodel, n, **overrides):
    js = jmodel.init_state(n, **overrides)
    ts = {k: _t(np.asarray(v)) for k, v in js.items()}
    return js, ts


def _step_both(jmodel, tmodel, js, ts, steps, clock0=0):
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    for k in range(steps):
        js, jspk, key = jmodel.step(js, key, clock0 + k)
        ts, tspk = tmodel.step(ts, gen, clock0 + k)
        np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk),
                                      err_msg=f"spikes, step {k}")
        for name, jv in js.items():
            tv = ts[name].numpy()
            if tv.dtype.kind in "biu":
                np.testing.assert_array_equal(tv, np.asarray(jv),
                                              err_msg=f"{name}, step {k}")
            else:
                np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-6,
                                           atol=0, err_msg=f"{name} {k}")
    return js, ts


def test_rate_train_matches_jax_step_for_step():
    rng = np.random.default_rng(0)
    rate = np.where(rng.random(64) < 0.2, 0.0,
                    rng.uniform(0.2, 3.0, 64)).astype(np.float32)
    jm, tm = snn.RateSpikeTrain(), snt.RateSpikeTrain()
    js, ts = _states(jm, tm, 64, rate=rate, dt=0.1)
    js, ts = _step_both(jm, tm, js, ts, 80)
    assert 0 < int(ts["is_spiking"].sum()) and (rate == 0).any()


def test_preset_train_matches_jax_step_for_step():
    rng = np.random.default_rng(1)
    ft = rng.uniform(0.1, 1.5, (32, 4)).astype(np.float32)
    jm, tm = snn.PresetSpikeTrain(), snt.PresetSpikeTrain()
    js = jm.init_state(32, firing_times=ft)
    ts = {k: _t(np.asarray(v)) for k, v in js.items()}
    assert set(ts) == set(tm.init_state(32, firing_times=ft))
    _step_both(jm, tm, js, ts, 60)


def test_poisson_and_bcm_trains_with_certain_chances_match_jax():
    """Chances of 0 and 1 make the draw irrelevant: every other field must
    follow the JAX trains exactly, BCM's activity bookkeeping included."""
    chance = np.tile(np.array([0.0, 1.0], np.float32), 16)
    for jm, tm in ((snn.PoissonSpikeTrain(), snt.PoissonSpikeTrain()),
                   (snn.BCMPoissonSpikeTrain(), snt.BCMPoissonSpikeTrain())):
        extra = dict(firing_rate_window=0.5) if tm.name == "bcm_poisson" \
            else {}
        js, ts = _states(jm, tm, 32, chance_of_firing=chance, **extra)
        _step_both(jm, tm, js, ts, 30)


def _effect_bound(kind, k, a, td, dt, want):
    """One ulp of the result plus (1 + 3|x|) ulps of a * exp(x)."""
    x = dt.astype(np.float64) / k * td.astype(np.float64) ** (
        2 if kind == "delta_dirac" else 1)
    amp = (a * np.exp(-x)).astype(np.float32)
    return (1.0 + 3.0 * x) * np.spacing(np.abs(amp)) \
        + np.spacing(np.abs(want).astype(np.float32))


@pytest.mark.parametrize("kind", ["delta_dirac", "exponential_decay"])
def test_refractoriness_effects_within_one_ulp(kind):
    """Over the trains' working range (decay k from 1000 to 20000 steps of
    dt, up to 300 steps since the last spike)."""
    rng = np.random.default_rng(2)
    n = 4096
    k = rng.uniform(1000.0, 20000.0, n).astype(np.float32)
    a = rng.uniform(5.0, 40.0, n).astype(np.float32)
    td = rng.integers(0, 300, n).astype(np.float32)
    rest = rng.uniform(-70.0, 0.0, n).astype(np.float32)
    dt = rng.uniform(0.05, 0.2, n).astype(np.float32)
    got = tst.REFRACTORINESS[kind](*map(_t, (k, a, td, rest, dt))).numpy()
    want = np.asarray(jst.REFRACTORINESS[kind](*map(jnp.asarray,
                                                    (k, a, td, rest, dt))))
    assert np.all(np.abs(got - want) <= _effect_bound(kind, k, a, td, dt,
                                                      want))
    assert (got == want).mean() > 0.9
    lft = np.where(rng.random(n) < 0.3, -1, rng.integers(0, 50, n))
    state = dict(last_firing_time=lft.astype(np.int32),
                 v_th=(rest + a).astype(np.float32), v_resting=rest,
                 dt=dt, **{"refractoriness$k": k})
    got = tst.refractoriness_effect(
        kind, {key: _t(v) for key, v in state.items()}, 60).numpy()
    want = np.asarray(jst.refractoriness_effect(
        kind, {key: jnp.asarray(v) for key, v in state.items()}, 60))
    td = (60 - lft).astype(np.float32)
    assert np.all(np.abs(got - want) <= _effect_bound(kind, k, a, td, dt,
                                                      want))
    np.testing.assert_array_equal(got[lft == -1], rest[lft == -1])


def test_poisson_firing_fraction_within_bound_of_chance():
    st = snt.SpikeTrainLattice(snt.PoissonSpikeTrain(), device="cpu")
    st.populate(64, 64, chance_of_firing=0.05)
    st.update_grid_history = True
    st.grid_history = snt.history.SpikeHistory()
    st.run_lattice(200)
    spikes = np.stack(st.grid_history.history)
    assert spikes.shape == (200, 64, 64)
    assert abs(spikes.mean() - 0.05) <= 0.002
    # the trains' voltages follow their spikes; firing times are the clock
    last = spikes[-1].reshape(-1)
    np.testing.assert_array_equal(st.state["is_spiking"].numpy(), last)
    np.testing.assert_array_equal(st.state["v"].numpy(),
                                  np.where(last, 30.0, 0.0))
    assert st.state["last_firing_time"].max().item() == 199
    # one seed, one stream: a second train of the same seed fires alike
    other = snt.SpikeTrainLattice(snt.PoissonSpikeTrain(), device="cpu")
    other.populate(64, 64, chance_of_firing=0.05)
    other.run_lattice(200)
    np.testing.assert_array_equal(other.state["last_firing_time"].numpy(),
                                  st.state["last_firing_time"].numpy())


def test_rate_train_lattice_run_matches_jax():
    """The standalone runner with a grid history, carried over from a JAX
    train lattice, against the JAX runner."""
    j = snn.SpikeTrainLattice(snn.RateSpikeTrain(), id=4)
    j.populate(6, 5, rate=0.7)
    j.update_grid_history = True
    t = spike_train_lattice_from(j, snt.RateSpikeTrain(), "cpu")
    for lat in (j, t):
        lat.run_lattice(45)
    assert t.internal_clock == j.internal_clock == 45
    np.testing.assert_array_equal(np.stack(t.grid_history.history),
                                  np.stack(j.grid_history.history))
    np.testing.assert_array_equal(t.state["last_firing_time"].numpy(),
                                  np.asarray(j.state["last_firing_time"]))


def test_set_dt_reset_timing_and_neurotransmitter_release_match_jax():
    jm, tm = snn.PoissonSpikeTrain(), snt.PoissonSpikeTrain()
    j = snn.SpikeTrainLattice(jm)
    j.populate(4, 4, chance_of_firing=0.03)
    t = spike_train_lattice_from(j, tm, "cpu")
    for lat in (j, t):
        lat.set_dt(0.25)
    np.testing.assert_array_equal(t.state["chance_of_firing"].numpy(),
                                  np.asarray(j.state["chance_of_firing"]))
    np.testing.assert_array_equal(t.state["dt"].numpy(),
                                  np.asarray(j.state["dt"]))
    t.internal_clock = 9
    t.state["last_firing_time"][:] = 3
    t.reset_timing()
    assert t.internal_clock == 0
    assert (t.state["last_firing_time"] == -1).all()
    # a Rate train with AMPA inserted releases after setting its spike flag
    jr, tr = snn.RateSpikeTrain(), snt.RateSpikeTrain()
    js, ts = _states(jr, tr, 8, rate=0.3)
    js = jr.insert_neurotransmitter(js, "AMPA", t_max=2.0)
    ts = tr.insert_neurotransmitter(ts, "AMPA", t_max=2.0)
    js, ts = _step_both(jr, tr, js, ts, 12)
    assert float(ts["nt$t"].max()) > 0.0
    with pytest.raises(ValueError):
        tr.insert_neurotransmitter(ts, "nope")
    with pytest.raises(ValueError):
        snt.RateSpikeTrain(refractoriness="nope")
    with pytest.raises(KeyError):
        tr.init_state(4, nope=1.0)

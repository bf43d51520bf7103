"""The port's support modules against the JAX package's on the CPU:
``analysis`` (peaks, Pearson correlation, EEG power density and earth
mover's distance), ``attractors`` (the Hopfield weight builders, the
pattern generators, `distort_pattern`, the discrete lattice),
``utils.distribution``, ``models.base.run_static_input`` and
``coupling``.

Tolerances: NumPy results equal; float32 reductions within rtol 1e-5
(the FFT within rtol 1e-4, atol 1e-6 of the spectrum's peak: another FFT
library); coupled-neuron steps within rtol 1e-5, atol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu import attractors as jatt
from spiking_neural_networks_tpu import coupling as jcoup
from spiking_neural_networks_tpu.analysis import (correlation as jcorr,
                                                  eeg as jeeg,
                                                  peaks as jpeaks)
from spiking_neural_networks_tpu_torch import attractors, coupling
from spiking_neural_networks_tpu_torch.analysis import (correlation, eeg,
                                                        peaks)
from spiking_neural_networks_tpu_torch.models.base import run_static_input
from spiking_neural_networks_tpu_torch.utils.distribution import (
    GaussianParameters, limited_distr)

torch.set_num_threads(1)


def series(seed, n=500):
    rng = np.random.default_rng(seed)
    t = np.arange(n) * 0.1
    return (np.sin(t * (1 + seed)) * 20 - 60
            + rng.normal(0, 3, n)).astype(np.float32)


# -- analysis ------------------------------------------------------------------


@pytest.mark.parametrize("tolerance", [None, 0.5, 2.0])
def test_peaks_match(tolerance):
    for seed in range(3):
        x = series(seed)
        assert peaks.find_peaks(x, tolerance) == \
            jpeaks.find_peaks(x, tolerance)
        assert peaks.find_peaks_above_threshold(x, -50) == \
            jpeaks.find_peaks_above_threshold(x, -50)
    plateau = [0, 1, 3, 3, 3, 1, 0, 2, 2, 0]
    assert peaks.find_peaks(plateau) == jpeaks.find_peaks(plateau) == [3, 7]


def test_pearsonr_matches_and_is_nan_at_zero_variance():
    x, y = series(0), series(1)
    np.testing.assert_allclose(float(correlation.pearsonr(x, y)),
                               float(jcorr.pearsonr(x, y)), rtol=1e-5)
    np.testing.assert_allclose(
        float(correlation.pearsonr(torch.from_numpy(x), x)), 1.0, rtol=1e-6)
    flat = np.full(50, 3.0, np.float32)
    assert np.isnan(float(correlation.pearsonr(flat, x[:50])))
    assert np.isnan(float(jcorr.pearsonr(flat, x[:50])))
    with pytest.raises(ValueError):
        correlation.pearsonr(x, y[:10])


def test_power_density_matches():
    x = series(2, 1000)
    f, s = eeg.get_power_density(x, 0.1, 100.0)
    jf, js = jeeg.get_power_density(x, 0.1, 100.0)
    assert f.dtype == torch.float32 and s.shape == (500,)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-6 * float(np.max(js)))


def test_earth_moving_distance_and_comparison_match():
    rng = np.random.default_rng(3)
    u, v = rng.normal(0, 1, 40), rng.normal(0.5, 2, 30)
    uw, vw = rng.random(40), rng.random(30)
    np.testing.assert_allclose(
        float(eeg.earth_moving_distance(u, v, uw, vw)),
        float(jeeg.earth_moving_distance(u, v, uw, vw)), rtol=1e-5)
    _, s1 = jeeg.get_power_density(series(4, 400), 0.1, 40.0)
    _, s2 = jeeg.get_power_density(series(5, 400), 0.1, 40.0)
    s1, s2 = np.asarray(s1), np.asarray(s2)
    np.testing.assert_allclose(
        float(eeg.power_density_comparison(s1, s2)),
        float(jeeg.power_density_comparison(s1, s2)), rtol=1e-4)
    assert float(eeg.power_density_comparison(s1, s1)) == 0.0
    with pytest.raises(ValueError):
        eeg.power_density_comparison(s1, s2[:-1])


# -- attractors ----------------------------------------------------------------


def test_hopfield_builders_match():
    pats = attractors.generate_random_patterns(5, 6, 3, 0.4, seed=2)
    np.testing.assert_array_equal(
        pats, jatt.generate_random_patterns(5, 6, 3, 0.4, seed=2))
    np.testing.assert_array_equal(attractors.generate_hopfield_network(pats),
                                  np.asarray(jatt.generate_hopfield_network(
                                      pats)))
    np.testing.assert_array_equal(
        attractors.generate_binary_hopfield_network(pats, 0.5, 0.25, 0.1),
        np.asarray(jatt.generate_binary_hopfield_network(pats, 0.5, 0.25,
                                                         0.1)))
    with pytest.raises(ValueError):
        attractors.generate_hopfield_network(pats[0])


def test_distort_pattern():
    pat = attractors.generate_random_patterns(8, 8, 1, 0.5, seed=1)[0]
    np.testing.assert_array_equal(attractors.distort_pattern(pat, 0.2, seed=4),
                                  jatt.distort_pattern(pat, 0.2, seed=4))
    g = torch.Generator().manual_seed(9)
    a = attractors.distort_pattern(pat, 0.3, generator=g)
    b = attractors.distort_pattern(
        pat, 0.3, generator=torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(a, b)
    assert 0 < (a != pat).sum() < pat.size
    assert (attractors.distort_pattern(pat, 0.0, seed=1) == pat).all()


def test_discrete_lattice_matches_and_recalls():
    pats = jatt.generate_random_patterns(6, 6, 2, 0.5, seed=3)
    w = attractors.generate_hopfield_network(pats)
    noisy = attractors.distort_pattern(pats[0], 0.1, seed=5)
    t = attractors.DiscreteNeuronLattice(6, 6, w, device="cpu")
    j = jatt.DiscreteNeuronLattice(6, 6, jnp.asarray(w))
    t.input_pattern_into_discrete_grid(noisy)
    j.input_pattern_into_discrete_grid(noisy)
    for _ in range(3):
        t.iterate()
        j.iterate()
        np.testing.assert_array_equal(t.convert_to_numerics(),
                                      j.convert_to_numerics())
    np.testing.assert_array_equal(t.convert_to_bools(), j.convert_to_bools())
    assert (t.convert_to_bools() == pats[0]).mean() > 0.9
    with pytest.raises(ValueError):
        t.input_pattern_into_discrete_grid(np.ones(5, bool))
    empty = attractors.DiscreteNeuronLattice.generate_lattice_from_dimension(
        2, 3, device="cpu")
    assert empty.weights.shape == (6, 6)


def test_the_ports_attractors_are_exported():
    assert snt.attractors is attractors and snt.coupling is coupling
    assert snt.analysis.peaks is peaks


# -- distribution and run_static_input -----------------------------------------


def test_limited_distr():
    g = torch.Generator().manual_seed(0)
    x = limited_distr(g, 1.0, 0.5, 0.5, 1.5, shape=(10000,))
    assert x.dtype == torch.float32 and x.shape == (10000,)
    assert x.min() >= 0.5 and x.max() <= 1.5
    assert abs(float(x.mean()) - 1.0) < 0.02
    # std 0: the mean, unclamped (distribution/mod.rs:10-12), as JAX
    y = limited_distr(g, 3.0, 0.0, 0.0, 2.0, shape=(4,))
    from spiking_neural_networks_tpu.utils.distribution import \
        limited_distr as jlimited
    jy = jlimited(jax.random.PRNGKey(0), 3.0, 0.0, 0.0, 2.0, shape=(4,))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    p = GaussianParameters(mean=2.0, std=0.0)
    assert (p.sample(g, (3,)) == 2.0).all()
    assert (p.max, p.min) == (2.0, 0.0)


def test_run_static_input_matches():
    model = snt.Izhikevich()
    state = model.init_state(3)
    state, volts = run_static_input(model, state, 30.0, 200)
    jm = snn.Izhikevich()
    from spiking_neural_networks_tpu.models.base import \
        run_static_input as jrun
    _, jv = jrun(jm, jm.init_state(3), 30.0, 200)
    assert volts.shape == (200, 3)
    np.testing.assert_allclose(volts.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-4)
    _, noisy = run_static_input(model, model.init_state(3), 30.0, 200,
                                generator=torch.Generator().manual_seed(1),
                                gaussian=(1.0, 0.2, 0.5, 1.5))
    assert noisy.shape == (200, 3) and torch.isfinite(noisy).all()
    assert not torch.equal(noisy, volts)


# -- coupling ------------------------------------------------------------------


def test_coupled_neurons_match():
    def states(m, n):
        return m.init_state(n), m.init_state(n)

    tm, jm = snt.Izhikevich(), snn.Izhikevich()
    tpre, tpost = states(tm, 4)
    jpre, jpost = states(jm, 4)
    for _ in range(100):
        tpre, tpost, ts, tp = coupling.iterate_coupled_spiking_neurons(
            tm, tpre, tpost, 30.0)
        jpre, jpost, js, jp = jcoup.iterate_coupled_spiking_neurons(
            jm, jpre, jpost, 30.0)
    np.testing.assert_allclose(tpost["v"].numpy(), np.asarray(jpost["v"]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    g = coupling.gap_junction(tpre, tpost)
    np.testing.assert_allclose(
        g.numpy(), np.asarray(jcoup.gap_junction(jpre, jpost)),
        rtol=1e-5, atol=1e-3)


def test_coupled_spike_train_step_matches():
    """A rate train (deterministic) drives pre, pre drives post; firing
    times stamped at the timestep."""
    tst = snt.RateSpikeTrain()
    jst = snn.RateSpikeTrain()
    tm, jm = snt.Izhikevich(), snn.Izhikevich()
    ts = tst.init_state(2, rate=5.0, v_th=30.0)
    js = jst.init_state(2, rate=5.0, v_th=30.0)
    tpre, tpost = tm.init_state(2), tm.init_state(2)
    jpre, jpost = jm.init_state(2), jm.init_state(2)
    g = None
    key = jax.random.PRNGKey(0)
    for t in range(500):
        ts, tpre, tpost, _, a, b, g = \
            coupling.iterate_coupled_spiking_neurons_and_spike_train(
                tst, tm, ts, tpre, tpost, t, generator=g)
        js, jpre, jpost, _, c, d, key = \
            jcoup.iterate_coupled_spiking_neurons_and_spike_train(
                jst, jm, js, jpre, jpost, t, key=key)
    for k in ("v", "last_firing_time"):
        np.testing.assert_allclose(tpost[k].numpy(), np.asarray(jpost[k]),
                                   rtol=1e-5, atol=1e-4, err_msg=k)
        np.testing.assert_allclose(tpre[k].numpy(), np.asarray(jpre[k]),
                                   rtol=1e-5, atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(ts["last_firing_time"].numpy(),
                                  np.asarray(js["last_firing_time"]))
    assert (tpre["last_firing_time"] >= 0).any()

"""The port's model fitting (`spiking_neural_networks_tpu_torch.fitting`)
against the JAX package's.

Exact: `decode_population`; `_selection` and `_crossover_mutate` on the JAX
package's own draws (its keys' uniforms and integers fed to the port's
operators); `run_coupled_trial`'s summaries with a deterministic Rate
train, electrical (Izhikevich, and ALIF at a (4, 2) batch) and chemical
(AMPA).  `compare_summary` and `scale_summary` within rtol 1e-6.  By
statistics (the port draws from torch, not JAX): the GA's convergence on
a quadratic, and the JAX package's two fitting scenarios
(``tests/test_analysis.py``) through the port on the CPU.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.fitting import fitting as jf
from spiking_neural_networks_tpu.fitting import ga as jga
from spiking_neural_networks_tpu_torch.fitting import fitting as tf
from spiking_neural_networks_tpu_torch.fitting import ga as tga
from spiking_neural_networks_tpu_torch.fitting import (
    FittingSettings, GeneticAlgorithmParameters, compare_summary,
    fit_neuron_to_neuron, genetic_algo, get_reference_summary,
    scale_summary)

torch.set_num_threads(1)


def test_decode_population_bit_equal():
    bits = np.random.default_rng(0).integers(0, 2, (16, 30)).astype(np.int32)
    bounds = [(0.01, 0.12), (-5.0, 5.0), (25.0, 150.0)]
    want = jga.decode_population(jnp.asarray(bits), bounds, 10)
    got = tga.decode_population(torch.from_numpy(bits), bounds, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = tga.decode_population(torch.tensor([[1, 1, 1, 1, 0, 0, 0, 0]]),
                                [(0.0, 1.0), (-5.0, 5.0)], 4)
    np.testing.assert_allclose(one.numpy(), [[1.0, -5.0]], atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_selection_on_jax_draws(seed):
    n_pop, k = 32, 3
    key = jax.random.PRNGKey(seed)
    # scores with ties, so that the first minimum must win in both
    scores = np.random.default_rng(seed).integers(0, 6, n_pop) \
        .astype(np.float32)
    want = jga._selection(key, jnp.asarray(scores), n_pop, k)
    idx = np.array(jax.random.randint(key, (n_pop, k), 0, n_pop))
    got = tga._selection(torch.from_numpy(idx).long(),
                         torch.from_numpy(scores))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crossover_mutate_on_jax_draws(seed):
    n_pop, total = 16, 24
    parents = np.random.default_rng(seed).integers(0, 2, (n_pop, total)) \
        .astype(np.int32)
    key = jax.random.PRNGKey(seed + 10)
    want = jga._crossover_mutate(key, jnp.asarray(parents), 0.9, 0.1)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = (np.array(jax.random.uniform(k1, (n_pop // 2, 1))),
             np.array(jax.random.randint(k2, (n_pop // 2, 1), 1, total)),
             np.array(jax.random.uniform(k3, (n_pop, total))))
    got = tga._crossover_mutate(torch.from_numpy(parents),
                                tuple(torch.from_numpy(d) for d in draws),
                                0.9, 0.1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_draw_generation_shapes_and_ranges():
    g = torch.Generator().manual_seed(4)
    idx, (u, points, m) = tga.draw_generation(g, 10, 7, 3)
    assert idx.shape == (10, 3) and 0 <= int(idx.min()) \
        and int(idx.max()) < 10
    assert u.shape == (5, 1) and points.shape == (5, 1)
    assert 1 <= int(points.min()) and int(points.max()) < 7
    assert m.shape == (10, 7) and float(m.max()) < 1.0


def pair_states(name, batch, seed, rate_v_th=80.0):
    """A random (batch, 2) neuron pair state of model ``name`` in both
    packages (gap conductance and the first parameter varied per member)
    and a Rate train broadcast to the batch."""
    rng = np.random.default_rng(seed)
    jm, tm = getattr(snn, name)(), getattr(snt, name)()
    n = int(np.prod(batch))
    over = {"gap_conductance": rng.uniform(10.0, 60.0, n).astype(np.float32)}
    if name == "Izhikevich":
        over["a"] = rng.uniform(0.01, 0.12, n).astype(np.float32)
    else:
        over["v_th"] = rng.uniform(-58.0, -50.0, n).astype(np.float32)
    js = jm.init_state(n, **{k: jnp.asarray(v) for k, v in over.items()})
    ts = tm.init_state(n, **{k: torch.from_numpy(v) for k, v in over.items()})
    jp = {k: v.reshape(batch + v.shape[1:])
          for k, v in jf._stack_pair(js).items()}
    tp = {k: v.reshape(batch + v.shape[1:])
          for k, v in tf._stack_pair(ts).items()}
    jst, tst = snn.RateSpikeTrain(), snt.RateSpikeTrain()
    rates = rng.uniform(0.5, 2.0, n).astype(np.float32)
    jt = jst.init_state(n, rate=jnp.asarray(rates), v_th=rate_v_th)
    tt = tst.init_state(n, rate=torch.from_numpy(rates), v_th=rate_v_th)
    jt = {k: v.reshape(batch + v.shape[1:]) for k, v in jt.items()}
    tt = {k: v.reshape(batch + v.shape[1:]) for k, v in tt.items()}
    return (jm, jst, jp, jt), (tm, tst, tp, tt)


@pytest.mark.parametrize("name,batch", [("Izhikevich", (8,)),
                                        ("AdaptiveLeakyIntegrateAndFire",
                                         (4, 2))])
def test_run_coupled_trial_electrical_matches_jax(name, batch):
    (jm, jst, jp, jt), (tm, tst, tp, tt) = pair_states(name, batch, 3)
    want = np.asarray(jf.run_coupled_trial(jm, jst, jp, jt, 400))
    got = tf.run_coupled_trial(tm, tst, tp, tt, 400)
    assert got.shape == batch + (4,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[..., 2].sum() > 0, "vacuous: no presynaptic spike"


def test_run_coupled_trial_chemical_matches_jax():
    """AMPA release from the Rate train into the pre neuron and from the
    pre neuron into the post neuron, the pair axis before the type axis."""
    out = []
    for pkg in (snn, snt):
        m = pkg.Izhikevich()
        kw = {} if pkg is snn else {"device": "cpu"}
        s = m.init_state(1, gap_conductance=20.0)
        s = m.insert_receptor(s, "AMPA")
        s = m.insert_neurotransmitter(s, "AMPA")
        stm = pkg.RateSpikeTrain()
        sts = stm.init_state(1, rate=1.0, v_th=80.0)
        sts = stm.insert_neurotransmitter(sts, "AMPA")
        if pkg is snn:
            out.append(np.asarray(jf.get_reference_summary(
                m, s, stm, sts, 300, chemical=True)))
        else:
            out.append(tf.get_reference_summary(
                m, s, stm, sts, 300, chemical=True, **kw).numpy())
    np.testing.assert_array_equal(out[1], out[0])
    assert out[0].shape == (1, 4) and out[0][0, 2] > 0


def test_compare_and_scale_summary_match_jax():
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 100, (6, 4)).astype(np.float32)
    b = rng.uniform(0, 100, (6, 4)).astype(np.float32)
    a[2, 1] = np.nan
    want = jf.compare_summary(jf.scale_summary(jnp.asarray(a), 800.0, 10.0),
                              jf.scale_summary(jnp.asarray(b), 800.0, 10.0))
    got = compare_summary(scale_summary(torch.from_numpy(a), 800.0, 10.0),
                          scale_summary(torch.from_numpy(b), 800.0, 10.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert np.isinf(got.numpy()[2])
    np.testing.assert_array_equal(
        scale_summary(torch.from_numpy(a), 800.0, 10.0).numpy(),
        np.asarray(jf.scale_summary(jnp.asarray(a), 800.0, 10.0)))


def test_chemical_poisson_summary_is_finite():
    """``tests/test_review_regressions.py``'s chemical coupled trial with a
    Poisson train: finite, shape (1, 4)."""
    m = snt.Izhikevich()
    s = m.init_state(1)
    s = m.insert_receptor(s, "AMPA")
    s = m.insert_neurotransmitter(s, "AMPA")
    stm = snt.PoissonSpikeTrain()
    sts = stm.init_from_firing_rate(1, hertz=100.0, dt=0.1)
    out = get_reference_summary(m, s, stm, sts, iterations=100,
                                chemical=True, device="cpu")
    assert out.shape == (1, 4)
    assert torch.isfinite(out).all()


def test_genetic_algo_minimizes_quadratic():
    params = GeneticAlgorithmParameters(
        bounds=[(-5.0, 5.0), (-5.0, 5.0)], n_bits=10, n_iter=30, n_pop=64,
        r_cross=0.9, r_mut=0.05, k=3)
    target = torch.tensor([1.5, -2.0])

    def objective(decoded):
        return torch.sum((decoded - target) ** 2, dim=-1)

    best, score, scores = genetic_algo(objective, params, device="cpu")
    assert len(scores) == 30 and scores[0].shape == (64,)
    assert score < 0.05
    np.testing.assert_allclose(best, [1.5, -2.0], atol=0.3)


def test_fit_neuron_to_neuron_recovers_parameter():
    """``tests/test_analysis.py``'s scenario: recover Izhikevich ``a`` =
    0.05 from a Rate train's summary (400 iterations, n_pop 32, n_iter
    10)."""
    model = snt.Izhikevich()
    st_model = snt.RateSpikeTrain()
    st_state = st_model.init_state(1, rate=2.0, v_th=30.0)
    ref_state = model.init_state(1, a=0.05, gap_conductance=10.0)
    ref = get_reference_summary(model, ref_state, st_model, st_state, 400,
                                device="cpu")

    def converter(params):
        return {"a": params[0], "gap_conductance": 10.0}

    settings = FittingSettings(
        neuron_model=model, st_model=st_model, spike_train_states=[st_state],
        reference_summaries=[ref[0]], scaling_factors=[(800.0, 10.0)],
        iterations=400, converter=converter)
    ga = GeneticAlgorithmParameters(bounds=[(0.01, 0.12)], n_bits=8,
                                    n_iter=10, n_pop=32, r_mut=0.08)
    best, score, _ = fit_neuron_to_neuron(
        settings, ga, generator=torch.Generator().manual_seed(3))
    fit_state = model.init_state(1, a=float(best[0]), gap_conductance=10.0)
    fit = get_reference_summary(model, fit_state, st_model, st_state, 400,
                                device="cpu")
    np.testing.assert_allclose(fit.numpy(), ref.numpy(), rtol=0.1, atol=2.0)
    assert score < 1.0


def test_population_scores_match_jax_objective():
    """One generation's scores for the same decoded population (``a`` and
    the gap conductance): the port's objective against the JAX package's
    (the same deterministic train), within rtol 1e-5, atol 1e-12 (JAX's
    jitted objective rounds a summary's quotient in another way: a member
    whose summary equals the reference scores 2.6e-18 there, 0 here)."""
    rng = np.random.default_rng(2)
    pops = np.stack([rng.uniform(0.01, 0.12, 12),
                     rng.uniform(10.0, 100.0, 12)], 1).astype(np.float32)
    out = []
    for pkg, f in ((snn, jf), (snt, tf)):
        model, stm = pkg.Izhikevich(), pkg.RateSpikeTrain()
        st = stm.init_state(1, rate=1.0, v_th=80.0)
        kw = {} if pkg is snn else {"device": "cpu"}
        ref = f.get_reference_summary(model, model.init_state(
            1, a=0.05, gap_conductance=30.0), stm, st, 300, **kw)
        settings = f.FittingSettings(
            model, stm, [st], [ref[0]], [(800.0, 10.0)], 300,
            lambda p: {"a": p[0], "gap_conductance": p[1]})
        captured = []

        def fake_ga(objective, params, *a, **k):
            captured.append(objective(
                jnp.asarray(pops) if pkg is snn else torch.from_numpy(pops)))
            return None, 0.0, []

        orig = f.genetic_algo
        f.genetic_algo = fake_ga
        try:
            f.fit_neuron_to_neuron(settings, GeneticAlgorithmParameters(
                bounds=[(0.01, 0.12), (10.0, 100.0)], n_pop=12), **kw)
        finally:
            f.genetic_algo = orig
        out.append(np.asarray(captured[0]))
    np.testing.assert_allclose(out[1], out[0], rtol=1e-5, atol=1e-12)
    assert np.unique(out[0]).size > 3


def test_fit_neuron_to_neuron_cross_family():
    """``tests/test_analysis.py``'s cross-family scenario through the port:
    an Izhikevich neuron fitted to an adaptive-LIF target over two drive
    rates (400 iterations, n_pop 64, n_iter 12)."""
    target_model, fit_model = snt.AdaptiveLeakyIntegrateAndFire(), \
        snt.Izhikevich()
    st_model = snt.RateSpikeTrain()
    st_states = [st_model.init_state(1, rate=2.0, v_th=30.0),
                 st_model.init_state(1, rate=5.0, v_th=30.0)]
    target = target_model.init_state(1, gap_conductance=10.0)
    refs = [get_reference_summary(target_model, target, st_model, st, 400,
                                  device="cpu") for st in st_states]
    scales = [(800.0, 10.0), (800.0, 10.0)]

    def converter(params):
        return {"a": params[0], "b": params[1], "c_m": params[2],
                "gap_conductance": 10.0}

    settings = FittingSettings(
        neuron_model=fit_model, st_model=st_model,
        spike_train_states=st_states,
        reference_summaries=[r[0] for r in refs], scaling_factors=scales,
        iterations=400, converter=converter)
    ga = GeneticAlgorithmParameters(
        bounds=[(0.005, 0.2), (0.1, 0.3), (25.0, 150.0)], n_bits=8,
        n_iter=12, n_pop=64, r_mut=0.08)
    best, score, _ = fit_neuron_to_neuron(
        settings, ga, generator=torch.Generator().manual_seed(5))
    assert np.isfinite(score)
    fit_state = fit_model.init_state(1, a=float(best[0]), b=float(best[1]),
                                     c_m=float(best[2]), gap_conductance=10.0)
    total = 0.0
    for st, ref, (ts, ps) in zip(st_states, refs, scales):
        fit = get_reference_summary(fit_model, fit_state, st_model, st, 400,
                                    device="cpu")
        total += float(compare_summary(scale_summary(fit[0], ts, ps),
                                       scale_summary(ref[0], ts, ps)))
    assert total < 0.5
    np.testing.assert_allclose(total, score, rtol=1e-5, atol=1e-6)

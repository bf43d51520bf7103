"""The Izhikevich model, its step template and the kinetics it calls,
against the JAX package on the same NumPy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spiking_neural_networks_tpu.models.integrate_and_fire import (
    Izhikevich as JIzhikevich)
from spiking_neural_networks_tpu.ops import kinetics as jk
from spiking_neural_networks_tpu.ops import receptors as jr
from spiking_neural_networks_tpu_torch.models.integrate_and_fire import (
    Izhikevich as TIzhikevich)
from spiking_neural_networks_tpu_torch.ops import kinetics as tk
from spiking_neural_networks_tpu_torch.ops import receptors as tr
from spiking_neural_networks_tpu_torch.convert import state_from_numpy

torch.set_num_threads(1)

# One elementwise f32 step: both sides run the same operations in the same
# association, so they differ by at most an ulp where the backends' exp or
# reductions round differently.  rtol 1e-6, atol 1e-5 is the JAX package's
# own fused-vs-XLA tolerance (tests/test_lattice.py); spikes are equal.
RTOL, ATOL = 1e-6, 1e-5


def assert_states_close(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def random_state(n, seed):
    """An Izhikevich host state with random v, w and previous spike flags."""
    rng = np.random.default_rng(seed)
    s = JIzhikevich().init_state_host(n, gap_conductance=10.0)
    s["v"] = rng.uniform(-65, 35, n).astype(np.float32)
    s["w"] = rng.uniform(0, 40, n).astype(np.float32)
    s["is_spiking"] = rng.random(n) < 0.3
    return s


def test_init_state_host_equal():
    overrides = dict(v=np.linspace(-70, 20, 12, dtype=np.float32),
                     gap_conductance=10.0, last_firing_time=3)
    j = JIzhikevich().init_state_host(12, **overrides)
    t = TIzhikevich().init_state_host(12, **overrides)
    assert list(t) == list(j)
    for k in j:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    ts = TIzhikevich().init_state(12, **overrides)
    assert ts["last_firing_time"].dtype == torch.int32
    assert ts["is_spiking"].dtype == torch.bool
    with pytest.raises(KeyError):
        TIzhikevich().init_state_host(3, nope=1.0)


@pytest.mark.parametrize("skip_nt", [True, False])
def test_step_matches_jax(skip_nt):
    n = 40
    host = random_state(n, seed=1)
    i = np.random.default_rng(2).uniform(-50, 50, n).astype(np.float32)
    jm, tm = JIzhikevich(), TIzhikevich()
    js = {k: jnp.asarray(v) for k, v in host.items()}
    ts = state_from_numpy(host, "cpu")
    if not skip_nt:
        js = jm.insert_neurotransmitter(js, "AMPA", t_max=2.0)
        ts = tm.insert_neurotransmitter(ts, "AMPA", t_max=2.0)
    js, jspk = jm.step(js, jnp.asarray(i), skip_nt=skip_nt)
    ts, tspk = tm.step(ts, torch.from_numpy(i), skip_nt=skip_nt)
    np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk))
    assert_states_close(ts, js)
    if not skip_nt:
        assert ts["nt$t"][:, 0].any()


def test_step_with_receptors_matches_jax():
    """The receptor branch of the template: kinetics update, currents from
    the pre-update v, v -= receptor dv."""
    n = 30
    host = random_state(n, seed=3)
    rng = np.random.default_rng(4)
    i = rng.uniform(-20, 20, n).astype(np.float32)
    t_in = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    t_valid = rng.random((n, 3)) < 0.8
    jm, tm = JIzhikevich(), TIzhikevich()
    js = {k: jnp.asarray(v) for k, v in host.items()}
    ts = state_from_numpy(host, "cpu")
    for name in ("AMPA", "NMDA", "GABA"):
        js = jm.insert_receptor(js, name)
        ts = tm.insert_receptor(ts, name)
    js = jm.insert_neurotransmitter(js, "NMDA")
    ts = tm.insert_neurotransmitter(ts, "NMDA")
    js, jspk = jm.step(js, jnp.asarray(i), jnp.asarray(t_in),
                       jnp.asarray(t_valid))
    ts, tspk = tm.step(ts, torch.from_numpy(i), torch.from_numpy(t_in),
                       torch.from_numpy(t_valid))
    np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk))
    assert_states_close(ts, js)


def _kinetics_state(seed, n=16, k=3):
    rng = np.random.default_rng(seed)
    s = {"nt$t": rng.uniform(0, 1.5, (n, k)).astype(np.float32),
         "nt$mask": rng.random((n, k)) < 0.6,
         "rec$r": rng.uniform(0, 1, (n, k)).astype(np.float32),
         "rec$mask": rng.random((n, k)) < 0.6,
         "dt": np.full(n, 0.1, np.float32)}
    for table in (jk.NT_PARAM_DEFAULTS, jk.REC_PARAM_DEFAULTS):
        for params in table.values():
            for f, d in params.items():
                s[f] = rng.uniform(0.5, 1.5, (n, k)).astype(np.float32) * d
    return s


@pytest.mark.parametrize("kind", sorted(jk.NT_KINETICS))
def test_apply_t_changes_matches_jax(kind):
    s = _kinetics_state(5)
    rng = np.random.default_rng(6)
    v = rng.uniform(-65, 35, 16).astype(np.float32)
    spk = rng.random(16) < 0.5
    want = jk.apply_t_changes(kind, {k: jnp.asarray(x) for k, x in s.items()},
                              jnp.asarray(v), jnp.asarray(spk))
    got = tk.apply_t_changes(kind, state_from_numpy(s, "cpu"),
                             torch.from_numpy(v), torch.from_numpy(spk))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("kind", sorted(jk.REC_KINETICS))
def test_update_receptor_kinetics_matches_jax(kind):
    s = _kinetics_state(7)
    rng = np.random.default_rng(8)
    t_in = rng.uniform(0, 1, (16, 3)).astype(np.float32)
    t_valid = rng.random((16, 3)) < 0.7
    want = jr.IonotropicReceptors(kind).update_kinetics(
        {k: jnp.asarray(x) for k, x in s.items()}, jnp.asarray(t_in),
        jnp.asarray(t_valid))["rec$r"]
    got = tr.IonotropicReceptors(kind).update_kinetics(
        state_from_numpy(s, "cpu"), torch.from_numpy(t_in),
        torch.from_numpy(t_valid))["rec$r"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_ionotropic_currents_and_insert_match_jax():
    n = 20
    rng = np.random.default_rng(9)
    host = JIzhikevich().init_state_host(n)
    host["rec$r"] = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    v = rng.uniform(-80, 30, n).astype(np.float32)
    jsys, tsys = jr.IonotropicReceptors(), tr.IonotropicReceptors()
    assert tsys.config_key()[1:] == jsys.config_key()[1:]
    js = jsys.insert({k: jnp.asarray(x) for k, x in host.items()}, "NMDA",
                     g=0.9, mg=0.5)
    js = jsys.insert(js, "GABA")
    ts = tsys.insert(state_from_numpy(host, "cpu"), "NMDA", g=0.9, mg=0.5)
    ts = tsys.insert(ts, "GABA")
    for k in ("rec$mask", "rec$g", "rec$mg"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    jcur = jsys.set_currents(js, jnp.asarray(v))["rec$current"]
    tcur = tsys.set_currents(ts, torch.from_numpy(v))["rec$current"]
    np.testing.assert_allclose(tcur.numpy(), np.asarray(jcur), rtol=RTOL,
                               atol=ATOL)
    js["rec$current"], ts["rec$current"] = jcur, tcur
    np.testing.assert_allclose(tsys.receptor_dv(ts).numpy(),
                               np.asarray(jsys.receptor_dv(js)),
                               rtol=RTOL, atol=ATOL)


def test_model_config_key_and_equality():
    assert TIzhikevich() == TIzhikevich()
    assert hash(TIzhikevich()) == hash(TIzhikevich())
    assert TIzhikevich() != TIzhikevich(nt_kinetics="discrete")
    with pytest.raises(ValueError):
        TIzhikevich().insert_neurotransmitter(
            TIzhikevich().init_state(2), "Dopamine")

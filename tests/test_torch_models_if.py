"""The port's integrate-and-fire family (`models/integrate_and_fire.py`:
QIF, AdEx, leaky Izhikevich, BCM Izhikevich, simple leaky, beside LIF, ALIF
and Izhikevich) and `DopaIzhikevich` against the JAX package's models: the
same numpy-seeded state and input through one ``step`` of each, then a few
steps more; their defaults; and `convert`'s carry-over of each class.

Tolerance: floats within rtol 1e-5 (atol 1e-6 for values near 0) after
each step, integers and spikes equal.  The models without a
transcendental round alike in both packages; AdEx's ``exp`` differs by an
ulp between XLA and PyTorch on the CPU.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu_torch.convert import _port_model
from spiking_neural_networks_tpu_torch.ops.model_kernels import KERNEL_FNS

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
# (JAX model, port model) pairs, by name
PAIRS = {
    "lif": lambda: (snn.LeakyIntegrateAndFire(),
                    snt.LeakyIntegrateAndFire()),
    "qif": lambda: (snn.QuadraticIntegrateAndFire(),
                    snt.QuadraticIntegrateAndFire()),
    "alif": lambda: (snn.AdaptiveLeakyIntegrateAndFire(),
                     snt.AdaptiveLeakyIntegrateAndFire()),
    "adex": lambda: (snn.AdaptiveExpLeakyIntegrateAndFire(),
                     snt.AdaptiveExpLeakyIntegrateAndFire()),
    "izhikevich": lambda: (snn.Izhikevich(), snt.Izhikevich()),
    "leaky_izhikevich": lambda: (snn.LeakyIzhikevich(),
                                 snt.LeakyIzhikevich()),
    "bcm": lambda: (snn.BCMIzhikevich(), snt.BCMIzhikevich()),
    "bcm_chemical": lambda: (
        snn.BCMIzhikevich(chemical_normalization=True),
        snt.BCMIzhikevich(chemical_normalization=True)),
    "simple_lif": lambda: (snn.SimpleLeakyIntegrateAndFire(),
                           snt.SimpleLeakyIntegrateAndFire()),
    "dopa": lambda: (snn.DopaIzhikevich(), snt.DopaIzhikevich()),
}


def random_state(jm, n, rng):
    """A NumPy state of ``n`` neurons of JAX model ``jm``: every float
    parameter within 20% of its default, v across threshold, a third of
    the neurons refractory or spiking, BCM windows of 5 steps."""
    s = jm.init_state_host(n)
    for k, d in jm.FIELDS.items():
        s[k] = (np.full(n, d) * rng.uniform(0.8, 1.2, n)).astype(np.float32)
    lo, hi = s["v_reset"].min() - 5 if "v_reset" in s else -70.0, \
        s["v_th"].max() + 5
    s["v"] = rng.uniform(lo, hi, n).astype(np.float32)
    s["is_spiking"] = rng.random(n) < 0.3
    if "refractory_count" in s:
        s["refractory_count"] = np.where(rng.random(n) < 0.3,
                                         rng.integers(1, 4, n), 0
                                         ).astype(np.float32)
    if "w" in s:
        s["w"] = rng.uniform(-5.0, 40.0, n).astype(np.float32)
    if "num_spikes" in s:
        s["num_spikes"] = rng.integers(0, 40, n).astype(np.int32)
        s["firing_rate_window"] = np.full(n, 0.5, np.float32)
        s["firing_rate_clock"] = rng.uniform(0, 0.5, n).astype(np.float32)
        s["current_activity"] = rng.uniform(0, 4, n).astype(np.float32)
        s["average_activity"] = rng.uniform(0, 4, n).astype(np.float32)
    return s


def assert_states_match(ts, js, keys):
    for k in keys:
        want = np.asarray(js[k])
        got = ts[k].numpy()
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_step_matches_jax(name):
    jm, tm = PAIRS[name]()
    rng = np.random.default_rng(sorted(PAIRS).index(name))
    n = 257
    s = random_state(jm, n, rng)
    js = {k: jnp.asarray(v) for k, v in s.items()}
    ts = {k: torch.from_numpy(np.array(v)) for k, v in s.items()}
    keys = [k for k in s if not k.startswith(("nt$", "rec$"))]
    for step in range(6):
        i = rng.uniform(-20.0, 60.0, n).astype(np.float32)
        js, jspk = jm.step(js, jnp.asarray(i), skip_nt=True)
        ts, tspk = tm.step(ts, torch.from_numpy(i), skip_nt=True)
        np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk))
        assert_states_match(ts, js, keys)
    assert set(ts) == set(js)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_fields_and_defaults_match_jax(name):
    jm, tm = PAIRS[name]()
    assert list(tm.FIELDS.items()) == list(jm.FIELDS.items())
    assert tm.BOOL_FIELDS == jm.BOOL_FIELDS
    assert tm.INT_FIELDS == jm.INT_FIELDS
    assert tm.name == jm.name
    js, ts = jm.init_state_host(5), tm.init_state_host(5)
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_array_equal(ts[k], np.asarray(js[k]), err_msg=k)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_convert_carries_the_model_class(name):
    jm, tm = PAIRS[name]()
    got = _port_model(jm)
    assert type(got) is type(tm)
    assert got.config_key()[1:] == tm.config_key()[1:]


def test_bcm_config_key_holds_the_normalization():
    a, b = snt.BCMIzhikevich(), snt.BCMIzhikevich(chemical_normalization=True)
    assert a != b and a.config_key()[-1] is False and b.config_key()[-1]


def test_bcm_bookkeeping_hits_its_window():
    """With a window of 0.3 (3 steps of dt 0.1) the activities move on
    every third step only, from the spikes counted so far."""
    tm = snt.BCMIzhikevich()
    s = tm.init_state(2, firing_rate_window=0.3)
    s["is_spiking"] = torch.tensor([True, False])
    seen = []
    for _ in range(6):
        s = tm.pre_update(s)
        seen.append(float(s["current_activity"][0]))
    assert seen[0] == seen[1] == 0.0 and seen[2] > 0.0
    assert seen[3] == seen[4] == seen[2] and seen[5] > seen[2]
    assert int(s["num_spikes"][0]) == 6 and int(s["num_spikes"][1]) == 0


def test_adex_kernel_fns_within_an_ulp_of_torch_exp():
    """The kernel twin's AdEx step (`KERNEL_FNS`) against the plain one."""
    jm, tm = PAIRS["adex"]()
    rng = np.random.default_rng(4)
    s = random_state(jm, 512, rng)
    ts = {k: torch.from_numpy(np.array(v)) for k, v in s.items()}
    i = torch.from_numpy(rng.uniform(-20, 60, 512).astype(np.float32))
    a, _ = tm.step(ts, i, skip_nt=True)
    b, _ = tm.step(ts, i, skip_nt=True, fns=KERNEL_FNS)
    torch.testing.assert_close(a["v"], b["v"], rtol=1e-6, atol=1e-6)

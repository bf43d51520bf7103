"""The port's Morris-Lecar model and its channels (`models/morris_lecar.py`,
`models/ion_channels.py`) against the JAX package's, and the kernels'
float-op ``kernel_tanh`` / ``kernel_cosh`` (`core/plasticity.py`) against
PyTorch's ``tanh`` / ``cosh``.

Tolerance: one step and the channels within rtol 1e-5, atol 1e-4;
``was_increasing`` and spikes equal.  The atol is an ulp of ``tanh`` near
+-1 carried through: ``1 + tanh(x)`` cancels where the gates are nearly
closed, so a last-bit difference of ``tanh`` (6e-8) is a large relative
error of ``m_ss`` there, and the currents take it times ``g |v - e|``
(up to ~1e3).  The static-input trace of the
upstream example (one neuron, 100 uA/cm^2, a limit cycle) within 1e-3 mV
over 4000 steps: XLA's and PyTorch's ``tanh`` and ``cosh`` differ in the
last bit, and a stable cycle does not amplify that.  ``kernel_tanh``
within 2e-7 of ``torch.tanh`` and ``kernel_cosh`` within 4 ulps of
``torch.cosh`` over the channels' argument range.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.models import ion_channels as jch
from spiking_neural_networks_tpu_torch.core.plasticity import (kernel_cosh,
                                                               kernel_tanh)
from spiking_neural_networks_tpu_torch.models import ion_channels as tch
from spiking_neural_networks_tpu_torch.ops.model_kernels import KERNEL_FNS

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4


def _ml_state(n, rng):
    """A Morris-Lecar state with v over the cycle's range, gates and
    currents at random values and was_increasing random."""
    s = snn.MorrisLecar().init_state_host(n)
    s["v"] = rng.uniform(-80.0, 40.0, n).astype(np.float32)
    s["kss$n"] = rng.uniform(0.0, 1.0, n).astype(np.float32)
    s["ca$m_ss"] = rng.uniform(0.0, 1.0, n).astype(np.float32)
    s["was_increasing"] = rng.random(n) < 0.5
    for k in ("ca$g", "kss$g", "leak$g", "kss$phi", "c_m"):
        s[k] = (s[k] * rng.uniform(0.8, 1.2, n)).astype(np.float32)
    return s


def _close(got, want, err=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=err)


def test_defaults_match_jax():
    jm, tm = snn.MorrisLecar(), snt.MorrisLecar()
    assert list(tm.FIELDS.items()) == list(jm.FIELDS.items())
    assert tm.BOOL_FIELDS == jm.BOOL_FIELDS
    assert (tm.nt_kinetics, tm.rec_kinetics) == (jm.nt_kinetics,
                                                 jm.rec_kinetics)
    for name in ("CA_REDUCED_DEFAULTS", "K_SS_DEFAULTS", "LEAK_DEFAULTS",
                 "CA_DEFAULTS"):
        assert getattr(tch, name) == getattr(jch, name)


def test_step_matches_jax():
    rng = np.random.default_rng(0)
    n = 513
    s = _ml_state(n, rng)
    jm, tm = snn.MorrisLecar(), snt.MorrisLecar()
    js = {k: jnp.asarray(v) for k, v in s.items()}
    ts = {k: torch.from_numpy(np.array(v)) for k, v in s.items()}
    for _ in range(5):
        i = rng.uniform(-50.0, 150.0, n).astype(np.float32)
        js, jspk = jm.step(js, jnp.asarray(i), skip_nt=True)
        ts, tspk = tm.step(ts, torch.from_numpy(i), skip_nt=True)
        np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk))
        for k in tm.FIELDS:
            _close(ts[k], js[k], k)
        np.testing.assert_array_equal(ts["was_increasing"].numpy(),
                                      np.asarray(js["was_increasing"]))


def test_kernel_fns_step_matches_plain_step():
    """The kernel twin's step (`KERNEL_FNS`) against the plain step."""
    rng = np.random.default_rng(1)
    s = {k: torch.from_numpy(np.array(v))
         for k, v in _ml_state(400, rng).items()}
    i = torch.from_numpy(rng.uniform(-50, 150, 400).astype(np.float32))
    a, sa = snt.MorrisLecar().step(s, i, skip_nt=True)
    b, sb = snt.MorrisLecar().step(s, i, skip_nt=True, fns=KERNEL_FNS)
    for k in snt.MorrisLecar.FIELDS:
        torch.testing.assert_close(b[k], a[k], rtol=RTOL, atol=ATOL)
    assert torch.equal(sa, sb)


def test_channels_match_jax():
    rng = np.random.default_rng(2)
    n = 1000
    v = rng.uniform(-90.0, 60.0, n).astype(np.float32)
    s = {**{k: np.full(n, d, np.float32) for k, d in
            {**jch.CA_REDUCED_DEFAULTS, **jch.K_SS_DEFAULTS,
             **jch.LEAK_DEFAULTS, **jch.CA_DEFAULTS}.items()}}
    s["kss$n"] = rng.uniform(0, 1, n).astype(np.float32)
    s["hva_ca$s_state"] = rng.uniform(0, 1, n).astype(np.float32)
    dt = np.full(n, 0.01, np.float32)
    js = {k: jnp.asarray(x) for k, x in s.items()}
    ts = {k: torch.from_numpy(x) for k, x in s.items()}
    jv, tv = jnp.asarray(v), torch.from_numpy(v)
    pairs = [(jch.reduced_calcium_update(js, jv),
              tch.reduced_calcium_update(ts, tv)),
             (jch.k_steady_state_update(js, jv, jnp.asarray(dt)),
              tch.k_steady_state_update(ts, tv, torch.from_numpy(dt))),
             (jch.leak_channel_update(js, jv),
              tch.leak_channel_update(ts, tv)),
             (jch.calcium_channel_update(js, jv / 10.0, jnp.asarray(dt)),
              tch.calcium_channel_update(ts, tv / 10.0,
                                         torch.from_numpy(dt)))]
    for jout, tout in pairs:
        assert set(tout) == set(jout)
        for k in jout:
            _close(tout[k], jout[k], k)


def test_static_input_trace_matches_jax():
    """The upstream example: one neuron under 100 uA/cm^2 for 4000 steps
    oscillates on a limit cycle in both packages."""
    jm, tm = snn.MorrisLecar(), snt.MorrisLecar()
    n_steps = 4000
    cur = jnp.asarray([100.0], jnp.float32)

    def step(s, _):
        s, _ = jm.step(s, cur)
        return s, s["v"][0]

    _, jv = jax.jit(lambda s: jax.lax.scan(step, s, None, length=n_steps))(
        jm.init_state(1))
    ts = tm.init_state(1)
    tcur = torch.tensor([100.0])
    tv = []
    for _ in range(n_steps):
        ts, _ = tm.step(ts, tcur)
        tv.append(float(ts["v"][0]))
    tv, jv = np.array(tv), np.asarray(jv)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-3)
    mid = 0.5 * (tv.min() + tv.max())
    assert int(((tv[:-1] < mid) & (tv[1:] >= mid)).sum()) >= 2


def test_kernel_tanh_within_2e7_of_torch_tanh():
    """Over the channels' arguments ((v - v_1) / v_2 and (v - v_3) / v_4
    for v in [-100, 100] mV: |x| < 6) and beyond, to where tanh is 1."""
    x = torch.cat([torch.linspace(-12.0, 12.0, 200001),
                   torch.from_numpy(np.random.default_rng(3).uniform(
                       -6, 6, 100000).astype(np.float32)),
                   torch.tensor([0.0, 1e-30, -1e-7, 1e-3, 20.0, -50.0,
                                 100.0])])
    got, want = kernel_tanh(x), torch.tanh(x)
    assert float((got - want).abs().max()) <= 2e-7
    assert bool((got.abs() <= 1.0).all())
    assert float(kernel_tanh(torch.tensor(100.0))) == 1.0


def test_kernel_cosh_within_4_ulps_of_torch_cosh():
    x = torch.cat([torch.linspace(-12.0, 12.0, 200001),
                   torch.from_numpy(np.random.default_rng(4).uniform(
                       -6, 6, 100000).astype(np.float32)),
                   torch.tensor([0.0, 1e-30, 30.0, -80.0])])
    got, want = kernel_cosh(x), torch.cosh(x)
    ulp = torch.from_numpy(np.spacing(want.numpy()))
    assert float(((got - want).abs() / ulp).max()) <= 4.0


def test_ml_lattice_routes():
    lat = snt.Lattice(snt.MorrisLecar(), device="cpu")
    lat.populate(6, 7)
    lat.connect_stencil(radius=1.0)
    lat.use_kernel = True
    lat.run_lattice(3)
    assert lat._last_run_fused == "model"
    lat.use_kernel = None          # auto: kernels only on a CUDA device
    lat.run_lattice(2)
    assert lat._last_run_fused is False and lat.internal_clock == 5


@pytest.mark.parametrize("fn,ref", [(kernel_tanh, np.tanh),
                                    (kernel_cosh, np.cosh)])
def test_kernel_fns_stay_float32(fn, ref):
    """The twins compute in float32 and stay within float32 rounding of
    the float64 functions."""
    x = torch.linspace(-5, 5, 101)
    y = fn(x)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), ref(x.numpy().astype(np.float64)),
                               rtol=1e-6, atol=2e-7)

"""sin, cos and tan on the kernel route (``core/plasticity.kernel_sin``,
``kernel_cos``, ``kernel_tan``; ``csrc/model_stencil.cuh``): accuracy
against float64 sin / cos / tan over the stated range, the points next to
multiples of pi/4 where a reduction that differs by one operation picks
another quadrant, the behaviour past the range and at NaN / +-inf, and the
JAX package's own tan sweep through a DSL neuron.

Tolerance: within 1 ulp of the float64 function, rounded to float32, for
|x| <= TRIG_EXACT_MAX (5e7, which covers the 2-ulp target up to 8192);
past it within |x| 2^-50 absolutely, finite and in [-1, 1] (sin, cos);
tan within rtol 1e-6 of np.tan on arange(-10, 10)
(``tests/test_dsl.py::test_dsl_builtin_functions_sweep``).
"""

import numpy as np
import pytest
import torch

import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu_torch.core.plasticity import (
    TRIG_EXACT_MAX, kernel_cos, kernel_sin, kernel_tan)
from spiking_neural_networks_tpu_torch.ops import model_kernels as mk

from test_dsl import TAN_NB

torch.set_num_threads(1)

FUNCS = {"sin": (kernel_sin, np.sin), "cos": (kernel_cos, np.cos),
         "tan": (kernel_tan, np.tan)}


def ulps(got, ref):
    """|got - ref| in ulps of ref rounded to float32."""
    u = np.spacing(np.abs(ref.astype(np.float32))).astype(np.float64)
    return np.abs(got.astype(np.float64) - ref) / u


def sample(seed, n=200_000):
    rng = np.random.default_rng(seed)
    sign = rng.choice([-1.0, 1.0], n)
    return np.concatenate([
        rng.uniform(-8192, 8192, n),
        sign * np.exp(rng.uniform(np.log(1e-30), np.log(TRIG_EXACT_MAX), n)),
        rng.uniform(-np.pi, np.pi, n)]).astype(np.float32)


def quarter_points(k_max=100_000, step=7):
    """The float32 values nearest k pi/4 and their neighbours, for k up to
    `k_max` (every ``step``-th k past 1000) and the largest k in range."""
    k = np.concatenate([np.arange(-1000, 1001),
                        np.arange(1001, k_max, step),
                        -np.arange(1001, k_max, step),
                        [int(TRIG_EXACT_MAX / (np.pi / 4))]])
    base = (k * (np.pi / 4)).astype(np.float32)
    base = base[np.abs(base) <= TRIG_EXACT_MAX]
    return np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                           np.nextafter(base, np.float32(-np.inf))])


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_within_one_ulp_over_the_range(name):
    f, ref = FUNCS[name]
    x = sample(seed=len(name))
    got = f(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert ulps(got, ref(x.astype(np.float64))).max() <= 1.0


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_within_one_ulp_next_to_multiples_of_a_quarter_pi(name):
    """Where the quadrant turns (k pi/4), and where sin / cos / tan cross
    zero, the remainder is small: a reduction off by one operation gives
    another quadrant or loses the remainder's digits."""
    f, ref = FUNCS[name]
    x = quarter_points()
    assert ulps(f(torch.from_numpy(x)).numpy(),
                ref(x.astype(np.float64))).max() <= 1.0


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_past_the_range_stated_error_and_finite(name):
    f, ref = FUNCS[name]
    rng = np.random.default_rng(4)
    x = (np.exp(rng.uniform(np.log(TRIG_EXACT_MAX), np.log(1e12), 4000))
         * rng.choice([-1.0, 1.0], 4000)).astype(np.float32)
    got = f(torch.from_numpy(x)).numpy().astype(np.float64)
    want = ref(x.astype(np.float64))
    assert np.isfinite(got).all()
    if name == "tan":
        # the remainder's error |x| 2^-52, carried through tan's slope
        slope = 1.0 + want * want
        assert (np.abs(got - want) <= np.abs(x) * 2.0**-50 * slope
                + 2 * np.spacing(np.abs(want))).all()
    else:
        assert (np.abs(got - want) <= np.abs(x) * 2.0**-50
                + 2 * np.spacing(np.abs(want))).all()
    huge = torch.tensor([1e20, -1e30, 3.4e38, -3.4e38, 2.0**100])
    y = f(huge)
    assert torch.isfinite(y).all()
    if name != "tan":
        assert (y.abs() <= 1.0).all()


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_nan_and_infinities_give_nan(name):
    f, _ = FUNCS[name]
    y = f(torch.tensor([np.nan, np.inf, -np.inf]))
    assert torch.isnan(y).all()
    z = f(torch.tensor([0.0, -0.0, 1e-40, -1e-30]))
    assert torch.isfinite(z).all()


def test_tan_passes_the_jax_packages_sweep():
    """``np.tan`` on ``arange(-10, 10)`` within rtol 1e-6, as
    ``tests/test_dsl.py`` holds the JAX package's TanNeuron, through the
    port's TanNeuron with the kernel route's functions."""
    x = np.arange(-10, 10, dtype=np.float32)
    np.testing.assert_allclose(kernel_tan(torch.from_numpy(x)).numpy(),
                               np.tan(x), rtol=1e-6)
    model = snt.dsl.neuron_builder(TAN_NB)["TanNeuron"]()
    s = model.init_state(20)
    s, _ = model.step(s, torch.from_numpy(x), fns=mk.KERNEL_FNS)
    np.testing.assert_allclose(s["v"].numpy(), np.tan(x), rtol=1e-6)


def test_the_kernel_functions_are_the_twins():
    assert mk.KERNEL_FNS.sin is kernel_sin
    assert mk.KERNEL_FNS.cos is kernel_cos
    assert mk.KERNEL_FNS.tan is kernel_tan

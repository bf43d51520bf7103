"""The model kernel route of the port's `Lattice` (route ``"model"``) as a
whole, against the JAX package's `Lattice`: every model of the kernel's
table on the JAX package's test lattice (16 x 16, gap 10, radius 2, keep
0.8, graph seed 7, v0 uniform in [-65, 30)); the routing; and, on a CUDA
card only, the route on the card against the same route on the CPU.

* ``use_kernel=True`` on the CPU (the twin, in calls of 16 steps) against
  ``use_pallas=True`` (the TPU kernel in interpret mode) over 40 steps,
  two calls and a remainder of 8: floats within rtol 1e-5, atol 1e-4,
  integers, bools and firing times equal.
* ``use_kernel=False`` (the plain route) against ``use_pallas=False`` (the
  XLA path) over 200 steps: the reference's CPU-vs-GPU criterion, v within
  2 mV and firing times within 2 steps, allowing PERF.md's tie rule (fewer
  than 1% of the neurons outside it).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu_torch.convert import lattice_from
from spiking_neural_networks_tpu_torch.ops import model_kernels as mk

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
MODELS = {
    "lif": snn.LeakyIntegrateAndFire, "qif": snn.QuadraticIntegrateAndFire,
    "alif": snn.AdaptiveLeakyIntegrateAndFire,
    "adex": snn.AdaptiveExpLeakyIntegrateAndFire,
    "dopa": snn.DopaIzhikevich, "leaky_izhikevich": snn.LeakyIzhikevich,
    "bcm": snn.BCMIzhikevich,
    "bcm_chemical": lambda: snn.BCMIzhikevich(chemical_normalization=True),
    "simple_lif": snn.SimpleLeakyIntegrateAndFire,
    "morris_lecar": snn.MorrisLecar,
}


def pair(make, use_kernel, rows=16, cols=16, seed=3):
    """A JAX lattice of the JAX package's model test and its port."""
    j = snn.Lattice(make())
    j.populate(rows, cols, gap_conductance=10.0)
    j.connect_stencil(radius=2.0, keep_prob=0.8, seed=7)
    v0 = np.random.default_rng(seed).uniform(-65, 30, rows * cols)
    j.apply(lambda s: {**s, "v": jnp.asarray(v0, jnp.float32)})
    j.use_pallas = use_kernel
    t = lattice_from(j, device="cpu")
    t.use_kernel = use_kernel
    return j, t


def assert_state_match(t, j):
    fields, carry = mk.model_kernel_fields(t.model)
    for k in carry + ("last_firing_time",):
        want, got = np.asarray(j.state[k]), t.state[k].numpy()
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_kernel_route_matches_jax_kernel_route(name):
    j, t = pair(MODELS[name], True)
    j.run_lattice(40)
    t.run_lattice(40)
    assert j._last_run_fused == ("model",)
    assert t._last_run_fused == "model"
    assert t.internal_clock == j.internal_clock == 40
    assert_state_match(t, j)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_plain_route_matches_jax_xla_path(name):
    j, t = pair(MODELS[name], False)
    n = 200
    jv, tv = [], []
    for _ in range(n // 20):
        j.run_lattice(20)
        t.run_lattice(20)
        jv.append(np.asarray(j.state["v"]))
        tv.append(t.state["v"].numpy())
    assert t._last_run_fused is False and j._last_run_fused is False
    dv = np.abs(np.stack(tv) - np.stack(jv)).max(axis=0)
    dl = np.abs(t.state["last_firing_time"].numpy().astype(np.int64)
                - np.asarray(j.state["last_firing_time"]))
    outside = int(((dv > 2.0) | (dl > 2)).sum())
    assert outside <= t.n // 100, (outside, float(dv.max()), int(dl.max()))
    fk = int((t.state["last_firing_time"] >= 0).sum())
    fj = int((np.asarray(j.state["last_firing_time"]) >= 0).sum())
    assert abs(fk - fj) <= t.n // 100


def test_routes():
    """As the JAX package routes (``tests/test_pallas_model.py``): the
    Izhikevich lattice keeps the stencil kernel; the other models take the
    model kernel; HH without chemistry, a history, plasticity, a graph
    history and chemical synapses stay off it."""
    def route(model, setup=None):
        lat = snt.Lattice(model, device="cpu")
        lat.populate(6, 6)
        lat.connect_stencil(radius=1.5)
        lat.use_kernel = True
        if setup:
            setup(lat)
        lat.run_lattice(2)
        return lat._last_run_fused

    assert route(snt.Izhikevich()) == ("kernel", False)
    for cls in (snt.LeakyIntegrateAndFire, snt.AdaptiveLeakyIntegrateAndFire,
                snt.DopaIzhikevich, snt.MorrisLecar, snt.BCMIzhikevich):
        assert route(cls()) == "model"
    assert route(snt.HodgkinHuxley()) is False

    def history(lat):
        lat.update_grid_history = True

    def graph_history(lat):
        lat.update_graph_history = True

    def stdp(lat):
        lat.do_plasticity = True

    def bcm(lat):
        lat.plasticity = snt.BCM()
        lat.do_plasticity = True

    def chemical(lat):
        lat.chemical_synapse = True

    assert route(snt.LeakyIntegrateAndFire(), history) is False
    assert route(snt.MorrisLecar(), graph_history) is False
    assert route(snt.LeakyIntegrateAndFire(), stdp) == ("stdp", False)
    assert route(snt.BCMIzhikevich(), bcm) is False
    assert route(snt.AdaptiveLeakyIntegrateAndFire(), chemical) is False
    # on a sparse graph
    lat = snt.Lattice(snt.LeakyIntegrateAndFire(), device="cpu")
    lat.populate(4, 4)
    lat.connect(lambda a, b: a != b and abs(a[0] - b[0]) + abs(a[1] - b[1])
                == 3)
    lat.use_kernel = True
    lat.run_lattice(2)
    assert lat._last_run_fused is False


def test_route_matches_jax_routes():
    for name in ("lif", "morris_lecar", "bcm"):
        j, t = pair(MODELS[name], True, 8, 8)
        j.update_grid_history = t.update_grid_history = True
        j.run_lattice(3)
        t.run_lattice(3)
        assert j._last_run_fused is False and t._last_run_fused is False


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MODELS))
def test_card_route_equals_cpu_route(name):
    _needs_cuda()
    j, _ = pair(MODELS[name], True, 40, 33)
    cpu = lattice_from(j, device="cpu")
    card = lattice_from(j, device="cuda")
    cpu.use_kernel, card.use_kernel = True, None
    cpu.run_lattice(40)
    card.run_lattice(40)
    assert card._last_run_fused == cpu._last_run_fused == "model"
    for k, v in cpu.state.items():
        assert torch.equal(card.state[k].cpu(), v), k

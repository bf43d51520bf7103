"""The model kernel (`ops/model_kernels.py`, ``csrc/model_stencil.cu``):
its field table against the JAX package's traced ``_model_kernel_fields``,
its plain twin against the TPU kernel it replaces
(`pallas_stencil.lattice_multistep_model`, run in interpret mode on the
CPU as ``tests/test_pallas_model.py`` runs it), its gate against the JAX
gate, the wrapper's CPU route and checks, and, on a CUDA card only, the
CUDA kernel against the twin.

Tolerance against the TPU kernel: floats within rtol 1e-5, atol 1e-4 (the
JAX package's own tolerance for this kernel), integers, bools and firing
times equal.  The twin takes the kernels' float-op ``exp`` / ``tanh`` /
``cosh``, the TPU kernel XLA's, which differ in the last bits; and XLA's
CPU backend contracts or reorders some operations in interpret mode, so
even the models without a transcendental differ by an ulp or two of v
(3e-5 mV at -70 mV).  On the card the kernel equals its twin bit for bit
(integers, bools and spikes equal, floats within rtol 1e-6, atol 1e-5).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.ops import graph as jg
from spiking_neural_networks_tpu.ops import pallas_stencil as jps
from spiking_neural_networks_tpu_torch.convert import (
    _port_model, stencil_graph_from_numpy)
from spiking_neural_networks_tpu_torch.ops import model_kernels as mk
from spiking_neural_networks_tpu_torch.ops.graph import SparseGraph

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
# the JAX models of the kernel's table
JMODELS = {
    "lif": snn.LeakyIntegrateAndFire, "qif": snn.QuadraticIntegrateAndFire,
    "alif": snn.AdaptiveLeakyIntegrateAndFire,
    "adex": snn.AdaptiveExpLeakyIntegrateAndFire,
    "dopa": snn.DopaIzhikevich,
    "leaky_izhikevich": snn.LeakyIzhikevich, "bcm": snn.BCMIzhikevich,
    "bcm_chemical": lambda: snn.BCMIzhikevich(chemical_normalization=True),
    "simple_lif": snn.SimpleLeakyIntegrateAndFire,
    "morris_lecar": snn.MorrisLecar,
}
_DTYPES = {jnp.float32: torch.float32, jnp.bool_: torch.bool,
           jnp.int32: torch.int32}


def jax_lattice(name, rows=16, cols=16, seed=3):
    """The JAX package's test lattice (``tests/test_pallas_model.py``):
    gap 10, radius 2, keep 0.8, graph seed 7, v0 uniform in [-65, 30)."""
    lat = snn.Lattice(JMODELS[name]())
    lat.populate(rows, cols, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=7)
    v0 = np.random.default_rng(seed).uniform(-65, 30, rows * cols)
    lat.apply(lambda s: {**s, "v": jnp.asarray(v0, jnp.float32)})
    return lat


def port_planes(model, state, shape):
    fields, _ = mk.model_kernel_fields(model)
    return {k: torch.from_numpy(np.array(state[k])).reshape(shape)
            for k, _ in fields}


def assert_carried_match(tm, got, want):
    """The twin's carried planes against the JAX state's fields."""
    fields = dict(mk.model_kernel_fields(tm)[0])
    for k, t in got.items():
        w = np.asarray(want[k]).reshape(t.shape)
        if fields[k] != torch.float32:
            np.testing.assert_array_equal(t.numpy(), w, err_msg=k)
        else:
            np.testing.assert_allclose(t.numpy(), w, rtol=RTOL, atol=ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("name", sorted(JMODELS))
def test_fields_match_jax_traced_fields(name):
    jm = JMODELS[name]()
    jfields, jcarry = jps._model_kernel_fields(jm)
    fields, carry = mk.model_kernel_fields(_port_model(jm))
    assert [k for k, _ in fields] == [k for k, _ in jfields]
    assert [dt for _, dt in fields] == [_DTYPES[dt] for _, dt in jfields]
    assert carry == jcarry


def test_hodgkin_huxley_has_no_kernel_fields():
    assert jps._model_kernel_fields(snn.HodgkinHuxley()) is None
    assert mk.model_kernel_fields(snt.HodgkinHuxley()) is None


def test_izhikevich_is_left_to_the_stencil_kernel():
    """The plain Izhikevich is outside the table: the stencil kernel's gate
    takes every Izhikevich lattice this kernel's gate would."""
    from spiking_neural_networks_tpu_torch.ops import stencil_kernels
    g = snt.StencilGraph.build(6, 6, snt.radius_offsets(2.0), device="cpu")
    assert mk.model_kernel_fields(snt.Izhikevich()) is None
    assert not mk.supports_model(snt.Izhikevich(), g, True, False, False)
    assert stencil_kernels.supports(snt.Izhikevich(), g, True, False, False)


def _random_planes(model, rng, shape):
    """Random kernel planes: the defaults with every float within 20% and
    v uniform in [-80, 40), random spike and peak flags, refractory
    counts, BCM counts, clocks and windows of 5 steps."""
    fields, _ = mk.model_kernel_fields(model)
    st = model.init_state(shape[0] * shape[1], device="cpu")
    planes = {}
    for k, dt in fields:
        p = st[k].reshape(shape).numpy()
        if dt == torch.float32:
            p = p * rng.uniform(0.8, 1.2, shape)
        elif dt == torch.bool:
            p = rng.random(shape) < 0.4
        else:
            p = rng.integers(0, 40, shape)
        planes[k] = torch.from_numpy(np.asarray(p).astype(
            {torch.float32: np.float32, torch.bool: np.bool_,
             torch.int32: np.int32}[dt]))
    planes["v"] = torch.from_numpy(
        rng.uniform(-80.0, 40.0, shape).astype(np.float32))
    if "refractory_count" in planes:
        planes["refractory_count"] = torch.from_numpy(np.where(
            rng.random(shape) < 0.3, 3.0, 0.0).astype(np.float32))
    if "firing_rate_window" in planes:
        planes["firing_rate_window"] = torch.full(shape, 0.5)
        planes["firing_rate_clock"] = torch.from_numpy(
            rng.uniform(0.0, 0.5, shape).astype(np.float32))
    return planes


def _perturbed(p, rng):
    if p.dtype == torch.float32:
        return p * torch.from_numpy(rng.uniform(1.1, 1.5, p.shape).astype(
            np.float32)) + 0.25
    return ~p if p.dtype == torch.bool else p + 1


def _same(a, b):
    """Bitwise equality (so that NaNs in both count as equal)."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(JMODELS))
def test_read_fields_are_what_the_step_reads(name):
    """`model_read_fields` (the fields the CUDA layout marks READ, and what
    the kernel's byte bound counts) against the model's own step: a field
    outside it changes no output of a step when perturbed, a field in it
    changes some output."""
    model = _port_model(JMODELS[name]())
    rng = np.random.default_rng(11)
    shape = (16, 16)
    planes = _random_planes(model, rng, shape)
    g = snt.StencilGraph.build(*shape, snt.radius_offsets(2.0),
                               keep_prob=0.8, seed=7, device="cpu")
    lft = torch.full(shape, -1, dtype=torch.int32)
    run = lambda pl: mk.model_steps_reference(
        model, pl, lft, g.weights, g.in_deg, g.offsets, 3, 1)
    base = run(planes)
    reads = mk.model_read_fields(model)
    for k, _ in mk.model_kernel_fields(model)[0]:
        out = run(dict(planes, **{k: _perturbed(planes[k], rng)}))
        same = all(_same(out[0][c], base[0][c]) for c in base[0]) \
            and _same(out[1], base[1]) and _same(out[2], base[2])
        assert same != (k in reads), (k, "read" if k in reads else "unread")


@pytest.mark.parametrize("n_steps", [16, 7])
@pytest.mark.parametrize("name", sorted(JMODELS))
def test_twin_matches_tpu_kernel(name, n_steps):
    jlat = jax_lattice(name)
    shape = (16, 16)
    jlat.state["last_firing_time"] = jnp.asarray(np.where(
        np.random.default_rng(5).random(256) < 0.2, 2, -1).astype(np.int32))
    want = jps.lattice_multistep_model(jlat.model, jlat.state, jlat.graph,
                                       9, n_steps)
    tm = _port_model(jlat.model)
    g = jlat.graph
    tg = stencil_graph_from_numpy(g.offsets, np.asarray(g.weights),
                                  np.asarray(g.mask), np.asarray(g.in_deg),
                                  "cpu")
    lft = torch.from_numpy(np.array(jlat.state["last_firing_time"])
                           ).reshape(shape)
    carried, tlft, spikes = mk.model_steps_reference(
        tm, port_planes(tm, jlat.state, shape), lft, tg.weights, tg.in_deg,
        tg.offsets, 9, n_steps)
    assert_carried_match(tm, carried, want)
    np.testing.assert_array_equal(
        tlft.numpy(), np.asarray(want["last_firing_time"]).reshape(shape))
    np.testing.assert_array_equal(
        spikes.numpy(), np.asarray(want["is_spiking"]).reshape(shape))


@pytest.mark.parametrize("name", sorted(JMODELS))
def test_gate_matches_jax_gate(name):
    jm = JMODELS[name]()
    tm = _port_model(jm)
    jstencil = jg.StencilGraph.build(6, 6, jg.radius_offsets(1.5))
    tstencil = stencil_graph_from_numpy(
        jstencil.offsets, np.asarray(jstencil.weights),
        np.asarray(jstencil.mask), np.asarray(jstencil.in_deg), "cpu")
    tsparse = SparseGraph.empty(36)
    for elec, chem, plastic in ((True, False, False), (True, True, False),
                                (True, False, True), (False, False, False)):
        want = jps.supports_model(jm, jstencil, elec, chem, plastic)
        assert mk.supports_model(tm, tstencil, elec, chem, plastic) == want
        assert not mk.supports_model(tm, tsparse, elec, chem, plastic)


def test_gate_refuses_hodgkin_huxley_and_wide_stencils():
    g = snt.StencilGraph.build(12, 12, snt.radius_offsets(5.0),
                               device="cpu")
    assert len(g.offsets) > mk.MAX_OFFSETS
    assert not mk.supports_model(snt.LeakyIntegrateAndFire(), g, True,
                                 False, False)
    g = snt.StencilGraph.build(6, 6, snt.radius_offsets(2.0), device="cpu")
    assert not mk.supports_model(snt.HodgkinHuxley(), g, True, False, False)
    assert mk.supports_model(snt.MorrisLecar(), g, True, False, False)


def _inputs(model, shape=(5, 6)):
    g = snt.StencilGraph.build(*shape, snt.radius_offsets(1.0),
                               device="cpu")
    st = model.init_state(shape[0] * shape[1], device="cpu")
    fields, _ = mk.model_kernel_fields(model)
    planes = {k: st[k].reshape(shape) for k, _ in fields}
    lft = st["last_firing_time"].reshape(shape)
    return planes, lft, g


def test_wrapper_runs_the_twin_on_the_cpu():
    model = snt.AdaptiveExpLeakyIntegrateAndFire()
    planes, lft, g = _inputs(model)
    planes["v"] = torch.linspace(-80, -40, 30).reshape(5, 6)
    before = mk.LAUNCHES
    got = mk.model_steps(model, planes, lft, g.weights, g.in_deg, g.offsets,
                         4, 5)
    want = mk.model_steps_reference(model, planes, lft, g.weights,
                                    g.in_deg, g.offsets, 4, 5)
    assert mk.LAUNCHES == before          # counts CUDA launches only
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert int((got[1] >= 0).sum()) > 0


def test_wrapper_raises_for_other_devices_and_bad_inputs():
    model = snt.MorrisLecar()
    planes, lft, g = _inputs(model)
    meta = {k: torch.empty_like(p, device="meta") for k, p in planes.items()}
    with pytest.raises(ValueError, match="no kernel for device"):
        mk.model_steps(model, meta, torch.empty_like(lft, device="meta"),
                       g.weights.to("meta"), g.in_deg.to("meta"), g.offsets,
                       0, 4)
    with pytest.raises(ValueError, match="no kernel for model"):
        mk.model_steps(snt.HodgkinHuxley(), planes, lft, g.weights,
                       g.in_deg, g.offsets, 0, 4)
    bad = dict(planes, was_increasing=planes["was_increasing"].float())
    with pytest.raises(ValueError, match="was_increasing"):
        mk.model_steps(model, bad, lft, g.weights, g.in_deg, g.offsets, 0, 4)
    with pytest.raises(KeyError, match="kss"):
        mk.model_steps(model, {k: p for k, p in planes.items()
                               if not k.startswith("kss")}, lft, g.weights,
                       g.in_deg, g.offsets, 0, 4)
    with pytest.raises(ValueError, match="n_steps"):
        mk.model_steps(model, planes, lft, g.weights, g.in_deg, g.offsets,
                       0, 0)


def test_kinds_are_distinct_and_bcm_normalizations_differ():
    kinds = [mk.kind(_port_model(JMODELS[n]())) for n in sorted(JMODELS)]
    assert len(set(kinds)) == len(kinds)


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [16, 7])
@pytest.mark.parametrize("name", sorted(JMODELS))
def test_cuda_kernel_matches_twin(name, n_steps):
    _needs_cuda()
    jlat = jax_lattice(name, 33, 70)
    tm = _port_model(jlat.model)
    shape = (33, 70)
    g = jlat.graph
    tg = stencil_graph_from_numpy(g.offsets, np.asarray(g.weights),
                                  np.asarray(g.mask), np.asarray(g.in_deg),
                                  "cuda")
    planes = {k: p.cuda() for k, p in
              port_planes(tm, jlat.state, shape).items()}
    lft = torch.from_numpy(np.array(jlat.state["last_firing_time"])
                           ).reshape(shape).cuda()
    got = mk.model_steps(tm, planes, lft, tg.weights, tg.in_deg, tg.offsets,
                         9, n_steps)
    torch.cuda.synchronize()
    want = mk.model_steps_reference(tm, planes, lft, tg.weights, tg.in_deg,
                                    tg.offsets, 9, n_steps)
    for k, t in want[0].items():
        if t.dtype == torch.float32:
            torch.testing.assert_close(got[0][k], t, rtol=1e-6, atol=1e-5)
        else:
            assert torch.equal(got[0][k], t), k
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])

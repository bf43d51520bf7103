"""Kernel 4's DSL arm (``ops/dsl_kernels.py``): the emitter, the generated
source, the route, and the kernel against its twin on a card.

* The layout of each generated neuron (fields, the carried set, the codes)
  against the JAX package's forwarding analysis
  (`pallas_stencil._model_kernel_fields`), `DSL_ALIAS`'s ``prev_v``
  included.
* The twin (``use_kernel=True`` on the CPU, calls of 16) against the JAX
  package's ``use_pallas=True`` (kernel 4 in interpret mode) over 40 steps
  on the 16 x 16 test lattice: floats within rtol 1e-5, atol 1e-4,
  integers, bools and firing times equal; the plain route against
  ``use_pallas=False`` over 200 steps within 2 mV and 2 steps (fewer than
  1% of the neurons outside: the tie rule).
* The gate: a chemical lattice, a history and more than 32 fields take
  the plain route, sin / cos / tan the kernel route; a DSL Izhikevich
  never the stencil kernel.
* The trig neuron (sin, cos, tan) on the kernel route against the JAX
  kernel in interpret mode: one step within rtol 1e-5, and 1000 steps
  within 2 mV and 2 steps (fewer than 1% of the neurons outside: the tie
  rule, as the plain routes are held).
* The generated build raises without nvcc.  The kernel in both designs
  against its twin on a card: ``tests/test_torch_dsl_cuda.py``.
"""

import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.dsl import neuron_builder as jnb
from spiking_neural_networks_tpu.ops import pallas_stencil as jps
from spiking_neural_networks_tpu_torch import _build
from spiking_neural_networks_tpu_torch.convert import lattice_from
from spiking_neural_networks_tpu_torch.core.plasticity import (
    kernel_ln, kernel_log10, kernel_pow, kernel_pow_nan, kernel_sinh)
from spiking_neural_networks_tpu_torch.dsl import neuron_builder as tnb
from spiking_neural_networks_tpu_torch.ops import dsl_kernels as dk
from spiking_neural_networks_tpu_torch.ops import model_kernels as mk
from spiking_neural_networks_tpu_torch.ops import stencil_kernels as sk

from test_dsl import BOOL_VARS_NB, FUNC_DECL_NB, IZHIKEVICH_NB
from test_dsl_reference_suite import HH_NB, ML_NB
from test_pallas_model import DSL_ALIAS, DSL_BRANCHY, DSL_IZHIKEVICH

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4

SIN_NB = """
[neuron]
    type: SinNeuron
    vars: v_reset = -75, v_th = -55, e = 0
    on_spike:
        v = v_reset
    spike_detection: v >= v_th
    on_iteration:
        dv/dt = (v - e) + sin(i)
[end]
"""

# sin, cos and tan on the kernel route: tan of the input current (as
# tests/test_dsl.py's TanNeuron, scaled so that the gap current stays
# away from tan's poles) and a sin / cos drive in dv/dt
TRIG_NB = """
[neuron]
    type: TrigNeuron
    vars: w = 30, a = 0.02, b = 0.2, c = -55, d = 8, v_th = 30, tau_m = 1, c_m = 100, drive = 0
    on_spike:
        v = c
        w += d
    spike_detection: v >= v_th
    on_iteration:
        drive = tan(i * 0.001)
        dw/dt = (a * (b * v - w)) / tau_m
        dv/dt = (0.04 * v * v + 5 * v + 140 - w + i + 4 * sin(v * 0.2) * cos(w * 0.1) + drive) / c_m
[end]
"""

FUNCS_NB = """
[neuron]
    type: FuncsNeuron
    vars: w = 1, a = 0.5, v_th = 30, c = -60
    on_spike:
        v = c
    spike_detection: v >= v_th
    on_iteration:
        x = abs(v) + 1
        w = sqrt(x) + ln(x) + log10(x) + sinh(w * 0.001) + cosh(a) + tanh(v * 0.01)
        dv/dt = floor(w) - ceil(a) + heaviside(v + 40) + min(v, 0) * max(a, 0.25) + ((x * 0.01) ^ 1.5) + ((v * 0.01) r^ 2) + i
[end]
"""

# model name -> (source, JAX-lattice run in the pallas test's form)
MODELS = {
    "KernelIzh": DSL_IZHIKEVICH,
    "KernelBranchy": DSL_BRANCHY,
    "KernelAlias": DSL_ALIAS,
    "DSLHodgkinHuxley": HH_NB,
    "DSLMorrisLecar": ML_NB,
    "FuncDeclNeuron": FUNC_DECL_NB,
    "BoolVarNeuron": BOOL_VARS_NB,
    "FuncsNeuron": FUNCS_NB,
    "TrigNeuron": TRIG_NB,
}
# the lattice pairs run on the JAX kernel in interpret mode (its Pallas
# trace of HH's body takes minutes there)
LATTICE_MODELS = ("KernelIzh", "KernelBranchy", "KernelAlias",
                  "DSLMorrisLecar", "FuncsNeuron", "TrigNeuron")


def both(name):
    src = MODELS[name]
    return jnb(src)[name], tnb(src)[name]


def pair(name, use_kernel, rows=16, cols=16, seed=3, steps_v=None):
    """The JAX package's model-kernel test lattice of a DSL neuron and its
    port (`convert.lattice_from` with the port's class)."""
    J, T = both(name)
    j = snn.Lattice(J())
    j.populate(rows, cols, gap_conductance=10.0)
    j.connect_stencil(radius=2.0, keep_prob=0.8, seed=7)
    v0 = np.random.default_rng(seed).uniform(-65, 30, rows * cols)
    j.apply(lambda s: {**s, "v": jnp.asarray(v0, jnp.float32)})
    j.use_pallas = use_kernel
    t = lattice_from(j, model=T(), device="cpu")
    t.use_kernel = use_kernel
    return j, t


@pytest.mark.parametrize("name", sorted(MODELS))
def test_layout_matches_jax_forwarding_analysis(name):
    J, T = both(name)
    lay = dk.layout(T())
    assert lay is not None, dk.reject_reason(T())
    jfields, jcarry = jps._model_kernel_fields(J())
    assert [k for k, _ in lay.fields] == [k for k, _ in jfields]
    assert set(lay.carry) == set(jcarry)
    fields, carry = mk.model_kernel_fields(T())
    assert fields == lay.fields and carry == lay.carry
    assert mk.kind(T()) == dk.DSL_KIND
    for (k, dt), code in zip(lay.fields, lay.codes):
        assert code & dk.BOOL == (dt == torch.bool)
        assert bool(code & dk.CARRIED) == (k in lay.carry)
        assert bool(code & dk.READ) == (k in lay.reads)
    assert {"v", "gap_conductance"} <= set(lay.reads)


def test_alias_carries_the_copied_field():
    """``prev_v = v``: prev_v's final value is v's input, not its own, so it
    is carried (the frozen field of the JAX package's first analysis)."""
    lay = dk.layout(both("KernelAlias")[1]())
    assert "prev_v" in lay.carry and "prev_v" not in lay.reads
    assert lay.codes[[k for k, _ in lay.fields].index("prev_v")] \
        == dk.F32 | dk.CARRIED


def test_read_set_by_perturbation():
    """A field outside a model's read set does not move its step: the read
    set is what the byte bound counts and what the layout marks READ."""
    for name in ("KernelBranchy", "DSLHodgkinHuxley", "FuncsNeuron"):
        T = both(name)[1]
        model = T()
        fields, carry = mk.model_kernel_fields(model)
        reads = mk.model_read_fields(model)
        rng = np.random.default_rng(0)
        st = model.init_state(64, v=torch.as_tensor(
            rng.uniform(-65, 30, 64), dtype=torch.float32))
        i = torch.as_tensor(rng.uniform(-5, 5, 64), dtype=torch.float32)
        base, _ = model.step(st, i, skip_nt=True, fns=mk.KERNEL_FNS)
        for k, dt in fields:
            if k in reads or dt != torch.float32:
                continue
            moved, _ = model.step(dict(st, **{k: st[k] + 3.0}), i,
                                  skip_nt=True, fns=mk.KERNEL_FNS)
            for c in carry:
                assert torch.equal(moved[c], base[c]), (name, k, c)


def test_generated_source_form():
    """One functor in an anonymous namespace over model_stencil.cuh, the
    four C entries, each DSL number as its float32 value exactly, masks as
    selects, deltas as 0.0f + d, pow and the kernel functions by name."""
    src = dk.generated_source(both("FuncsNeuron")[1]())
    assert '#include "model_stencil.cuh"' in src
    assert "namespace {" in src and "struct Dsl {" in src
    for entry in ("model_stencil_layout", "model_stencil_limits",
                  "model_stencil_steps", "model_stencil_persistent"):
        assert f"int {entry}(" in src or f"void {entry}(" in src
    for fn in ("kernel_ln(", "kernel_log10(", "kernel_sinh(", "kernel_cosh(",
               "kernel_tanh(", "sqrtf(", "fabsf(", "floorf(", "ceilf(",
               "ms_minimum(", "ms_maximum(", "ms_pow("):
        assert fn in src, fn
    assert "0.00999999978f" in src      # 0.01 as a float32
    izh = dk.generated_source(both("KernelBranchy")[1]())
    assert " ? " in izh
    zeros = set(re.findall(r"const float (x\d+) = 0\.0f;", izh))
    sums = re.findall(r"= (x\d+) \+ x\d+;", izh)
    assert zeros & set(sums)      # a delta accumulated as 0.0f + d
    assert dk.c_float(3.0) == "3.0f" and dk.c_float(-0.5) == "(-0.5f)"
    for x in (0.1, 1e-30, 3.4e38, 123456.789, 0.072):
        lit = dk.c_float(x)
        assert np.float32(float(lit.strip("()f"))) == np.float32(x)


def test_kernel_function_twins_are_close():
    """The DSL's new float-op forms against torch within a few ulps; pow
    keeps its exact cases."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(np.concatenate([rng.uniform(-30, 30, 4000),
                                        rng.uniform(-1.2, 1.2, 4000)]),
                        dtype=torch.float32)
    ref = torch.sinh(x.double())
    ulp = (torch.nextafter(ref.float().abs(), torch.tensor(np.inf))
           - ref.float().abs()).double()
    assert ((kernel_sinh(x).double() - ref).abs() / ulp).max() <= 2.0
    y = torch.as_tensor(rng.uniform(1e-5, 1e5, 4000), dtype=torch.float32)
    for f, g in ((kernel_ln, torch.log), (kernel_log10, torch.log10)):
        ref = g(y.double())
        ulp = (torch.nextafter(ref.float().abs(), torch.tensor(np.inf))
               - ref.float().abs()).double()
        assert ((f(y).double() - ref).abs() / ulp).max() <= 2.0
    edge = kernel_ln(torch.tensor([0.0, -1.0, np.inf, np.nan]))
    assert edge[0] == -np.inf and edge[2] == np.inf
    assert torch.isnan(edge[1]) and torch.isnan(edge[3])
    p = kernel_pow(torch.tensor([2.0, -2.0, 0.0, 5.0]),
                   torch.tensor([3.0, 3.0, 2.0, 0.0]))
    assert p.tolist() == [8.0, -8.0, 0.0, 1.0]
    # a NaN operand stays NaN on the kernel route (kernel_pow alone turns a
    # NaN x into a number)
    nan = torch.tensor([np.nan, 2.0, -np.nan])
    q = kernel_pow_nan(nan, torch.tensor([3.0, np.nan, 4.0]))
    assert torch.isnan(q).all()
    assert not torch.isnan(kernel_pow(nan[:1], torch.tensor([3.0]))).any()


@pytest.mark.parametrize("name", LATTICE_MODELS)
def test_twin_route_matches_jax_kernel_route(name):
    j, t = pair(name, True)
    j.run_lattice(40)
    t.run_lattice(40)
    assert j._last_run_fused == ("model",)
    assert t._last_run_fused == "model"
    _, carry = mk.model_kernel_fields(t.model)
    for k in carry + ("last_firing_time",):
        want, got = np.asarray(j.state[k]), t.state[k].numpy()
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("name", ["KernelIzh", "KernelBranchy",
                                  "DSLHodgkinHuxley", "DSLMorrisLecar"])
def test_plain_route_matches_jax_xla_path(name):
    j, t = pair(name, False)
    n = 200
    vj, vt, lj, lt = [], [], [], []
    for _ in range(n // 20):
        j.run_lattice(20)
        t.run_lattice(20)
        vj.append(np.asarray(j.state["v"]))
        vt.append(t.state["v"].numpy())
        lj.append(np.asarray(j.state["last_firing_time"]))
        lt.append(t.state["last_firing_time"].numpy())
    assert t._last_run_fused is False and j._last_run_fused is False
    dv = np.abs(np.stack(vj) - np.stack(vt))
    dl = np.abs(np.stack(lj).astype(np.int64) - np.stack(lt))
    outside = ((dv > 2.0) | (dl > 2)).any(axis=0)
    assert outside.sum() <= t.n // 100, int(outside.sum())


def test_twin_equals_plain_steps_of_the_kernel_functions():
    """The twin is the model's own step on (rows, cols) planes: one
    16-step call of `model_steps_reference` equals 16 `lattice_step`s of
    the plain route given the kernel's functions and gather, for the
    branchy model (where / masks / user functions)."""
    _, t = pair("KernelBranchy", True, rows=12, cols=10)
    fields, carry = mk.model_kernel_fields(t.model)
    shape = (12, 10)
    st, g = t.state, t.graph
    planes = {k: st[k].reshape(shape) for k, _ in fields}
    got = mk.model_steps_reference(t.model, planes,
                                   st["last_firing_time"].reshape(shape),
                                   g.weights, g.in_deg, g.offsets, 0, 16)
    run = mk.ModelRun(t.model, planes, st["last_firing_time"].reshape(shape),
                      g.weights, g.in_deg, g.offsets)
    again = run.steps(0, 16)
    for k in carry:
        assert torch.equal(got[0][k], again[0][k]), k
    assert torch.equal(got[1], again[1])


def lattice(src, name, **kw):
    lat = snt.Lattice(tnb(src)[name](), device="cpu")
    lat.populate(8, 8, gap_conductance=10.0, **kw)
    lat.connect_stencil(radius=1.5, seed=1)
    lat.use_kernel = True
    return lat


def test_gate_routes():
    # a sin model takes the kernel route (kernel_sin), as the trig one
    for src, name in ((SIN_NB, "SinNeuron"), (TRIG_NB, "TrigNeuron")):
        lat = lattice(src, name)
        assert dk.layout(lat.model) is not None
        assert dk.reject_reason(lat.model) is None
        assert mk.supports_model(lat.model, lat.graph, True, False, False)
        lat.run_lattice(20)
        assert lat._last_run_fused == "model"
    # a chemical lattice
    lat = lattice(IZHIKEVICH_NB, "DSLIzhikevich")
    assert mk.supports_model(lat.model, lat.graph, True, False, False)
    assert not mk.supports_model(lat.model, lat.graph, True, True, False)
    # a history
    lat.update_grid_history = True
    lat.run_lattice(20)
    assert lat._last_run_fused is False
    assert len(lat.grid_history.history) == 20
    lat.update_grid_history = False
    lat.run_lattice(16)
    assert lat._last_run_fused == "model"
    # a DSL Izhikevich never takes the stencil kernel (another association)
    assert not sk.supports(lat.model, lat.graph, True, False, False)
    # more than MAX_FIELDS fields
    many = ", ".join(f"p{k} = {k}" for k in range(dk.MAX_FIELDS))
    wide = IZHIKEVICH_NB.replace("vars: w = 30", f"vars: {many}, w = 30") \
        .replace("DSLIzhikevich", "WideIzhikevich")
    lat = lattice(wide, "WideIzhikevich")
    assert len(mk.kernel_fields(type(lat.model))) > dk.MAX_FIELDS
    assert dk.layout(lat.model) is None
    lat.run_lattice(16)
    assert lat._last_run_fused is False


def test_generated_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc here: the build raises, and nothing falls back."""
    monkeypatch.setattr(_build, "GENERATED_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    model = both("KernelIzh")[1]()
    with pytest.raises(RuntimeError, match="nvcc"):
        dk.load(model)
    with pytest.raises(RuntimeError, match="nvcc"):
        dk.build([model, both("KernelBranchy")[1]()])
    assert _build.generated_library_path(dk.generated_source(model)) \
        .startswith(str(tmp_path))


def test_library_name_follows_the_source():
    a = _build.generated_library_path(dk.generated_source(
        both("KernelIzh")[1]()))
    b = _build.generated_library_path(dk.generated_source(
        both("KernelAlias")[1]()))
    assert a != b and a.endswith(".so") and "libsnn_dsl-" in a
    assert a == _build.generated_library_path(dk.generated_source(
        both("KernelIzh")[1]()))


def test_lattice_from_needs_the_model_of_a_dsl_class():
    """`convert._port_model` has no class for a DSL neuron: it asks for
    ``model=`` (it failed with a bare StopIteration)."""
    J, T = both("KernelIzh")
    j = snn.Lattice(J())
    j.populate(4, 4)
    with pytest.raises(ValueError, match="model="):
        lattice_from(j, device="cpu")
    t = lattice_from(j, model=T(), device="cpu")
    assert isinstance(t.model, T)


@pytest.mark.parametrize("name", ["DSLHodgkinHuxley", "FuncDeclNeuron"])
def test_lattice_from_carries_a_dsl_lattice_key_for_key(name):
    J, T = both(name)
    j = snn.Lattice(J())
    j.populate(5, 6, gap_conductance=7.0)
    s = j.state
    for t in ("AMPA", "NMDA"):
        s = j.model.insert_receptor(s, t)
    j.state = s
    t = lattice_from(j, model=T(), device="cpu")
    assert set(t.state) == set(j.state)
    for k in j.state:
        np.testing.assert_array_equal(t.state[k].numpy(),
                                      np.asarray(j.state[k]), err_msg=k)
        assert t.state[k].dtype == torch.from_numpy(
            np.asarray(j.state[k])).dtype, k


def test_trig_neuron_one_step_matches_jax_kernel():
    """One step of the trig neuron on the kernel route (kernel_sin /
    kernel_cos / kernel_tan) against the JAX kernel in interpret mode
    (jnp.sin / cos / tan) within rtol 1e-5."""
    j, t = pair("TrigNeuron", True)
    j.run_lattice(1)
    t.run_lattice(1)
    assert j._last_run_fused == ("model",) and t._last_run_fused == "model"
    for k in ("v", "w", "drive"):
        np.testing.assert_allclose(t.state[k].numpy(), np.asarray(j.state[k]),
                                   rtol=RTOL, atol=0.0, err_msg=k)


def test_trig_neuron_1000_steps_match_jax_kernel():
    """1000 steps of the trig neuron, kernel route against the JAX kernel
    in interpret mode, read every 50 steps: voltage within 2 mV and last
    firing time within 2 steps, for all but 1% of the neurons (the tie
    rule: the two associations part at a threshold tie)."""
    j, t = pair("TrigNeuron", True)
    vj, vt, lj, lt = [], [], [], []
    for _ in range(20):
        j.run_lattice(50)
        t.run_lattice(50)
        vj.append(np.asarray(j.state["v"]))
        vt.append(t.state["v"].numpy())
        lj.append(np.asarray(j.state["last_firing_time"]))
        lt.append(t.state["last_firing_time"].numpy())
    assert t._last_run_fused == "model"
    assert (np.stack(lt) >= 0).any()
    dv = np.abs(np.stack(vj) - np.stack(vt))
    dl = np.abs(np.stack(lj).astype(np.int64) - np.stack(lt))
    outside = ((dv > 2.0) | (dl > 2)).any(axis=0)
    assert outside.sum() <= t.n // 100, int(outside.sum())


def test_trig_neuron_takes_at_most_two_cells_a_thread():
    """A step that calls sin / cos / tan (float64 in the kernel) caps the
    persistent design at `TRIG_MAX_CPT` cells a thread (its functor says
    so to the C side); the others keep their register rule."""
    trig = both("TrigNeuron")[1]()
    assert mk.max_cpt(trig) == dk.TRIG_MAX_CPT == 2
    assert "static constexpr int max_cpt = 2;" in dk.layout(trig).functor
    assert {"kernel_sin", "kernel_cos", "kernel_tan"} <= set(
        dk.layout(trig).ops)
    izh = both("KernelIzh")[1]()
    assert mk.max_cpt(izh) == mk.MAX_CPT
    assert "max_cpt" not in dk.layout(izh).functor
    # 512^2 still fits the persistent plan at 2 cells a thread; 700^2 not
    assert mk.persistent_plan(trig, (512, 512), 12, 132).cap <= 2 * mk.THREADS
    assert mk.persistent_plan(trig, (700, 700), 12, 132) is None

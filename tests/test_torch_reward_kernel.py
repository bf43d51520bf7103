"""The plasticity kernel's plain twin against the TPU kernel it replaces,
``pallas_reward._fused_chunk`` in its single-lattice form (run in interpret
mode on the CPU), through both packages' entry points; the wrapper's CPU
route, checks and gates; and, on a CUDA card only, the CUDA kernels
against the twin.

Tolerance: rtol 1e-6, atol 1e-5 on v, w, weights, traces and dopamine,
with firing times, spikes, refractory counts and trace counters equal.
The twin and the TPU kernel compute the same association; they differ
where XLA's CPU backend and PyTorch round an exp or contract a
multiply-add differently (1 ulp of exp(-dt / tau_d) in the dopamine).
"""

import numpy as np
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.ops import pallas_reward as jpr
from spiking_neural_networks_tpu.core.history import EEGHistory
from spiking_neural_networks_tpu_torch.core import history as th
from spiking_neural_networks_tpu_torch.ops import reward_kernels as rk
from torch_lattices import (MODELS, assert_lattices_match, bits_equal,
                            jax_lattice, port_of, schedule_inputs)

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-5
STEPS = 23                      # one K=16 call and a remainder of 7


def run_both(kind, model, with_reward, steps=STEPS):
    j = jax_lattice(model, kind, use_pallas=True)
    t = port_of(j, model, use_kernel=True)
    rewards = np.linspace(-0.1, 0.2, steps).astype(np.float32)
    for lat in (j, t):
        if kind == "plastic":
            lat.run_lattice(steps)
        elif with_reward:
            lat.run_lattice_with_reward(rewards, steps)
        else:
            lat.run_lattice(steps)
    return j, t


@pytest.mark.parametrize("kind,model,with_reward", [
    ("plastic", "izhikevich", False), ("plastic", "alif", False),
    ("plastic", "lif", False),
    ("mod", "izhikevich", True), ("mod", "alif", True), ("mod", "lif", True),
    ("mod", "izhikevich", False), ("mod", "alif", False),
    ("mod", "lif", False),
    ("plain", "alif", True)])
def test_twin_matches_tpu_kernel(kind, model, with_reward):
    """12 x 10, radius 2, keep 0.8, 23 steps: the twin (use_kernel=True
    on the CPU) against `_fused_chunk` in interpret mode
    (use_pallas=True)."""
    j, t = run_both(kind, model, with_reward)
    if kind == "plastic":
        assert j._last_run_fused[0] == "stdp"
        assert t._last_run_fused == ("stdp", False)
    else:
        assert j._last_run_fused is True and t._last_run_fused is True
    assert_lattices_match(t, j, RTOL, ATOL)
    assert (t.state["last_firing_time"] >= 3).any()      # spikes in the run


def test_twin_matches_tpu_kernel_with_grid_history():
    """STDP Izhikevich with a grid history: the kernel emits pre-reset v
    and the runners rebuild post-reset v from it."""
    j = jax_lattice("izhikevich", "plastic", use_pallas=True)
    t = port_of(j, "izhikevich", use_kernel=True)
    for lat in (j, t):
        lat.update_grid_history = True
        lat.run_lattice(STEPS)
    assert j._last_run_fused[0] == "stdp"
    assert t._last_run_fused == ("stdp", True)
    hj = np.stack(j.grid_history.history)
    ht = np.stack(t.grid_history.history)
    assert ht.shape == hj.shape == (STEPS, 12, 10)
    np.testing.assert_allclose(ht, hj, rtol=RTOL, atol=ATOL)
    assert_lattices_match(t, j, RTOL, ATOL)


def test_weights_and_traces_move():
    """Guard against a vacuous pass: the runs change weights and traces."""
    j = jax_lattice("izhikevich", "mod")
    _, t = run_both("mod", "izhikevich", True)
    assert np.abs(t.graph.weights.numpy() - np.asarray(j.graph.weights)).max() > 1e-2
    assert np.abs(t.trace["c"].numpy() - np.asarray(j.trace["c"])).max() > 1e-2
    j = jax_lattice("izhikevich", "plastic")
    _, t = run_both("plastic", "izhikevich", False)
    assert np.abs(t.graph.weights.numpy() - np.asarray(j.graph.weights)).max() > 1e-2


def _call_inputs(kind, model, rows=9, cols=11, seed=4):
    """One wrapper call's CPU tensors from a JAX lattice's numbers."""
    j = jax_lattice(model, "plastic" if kind == "plastic" else kind, rows,
                    cols, seed)
    t = port_of(j, model, use_kernel=True)
    st, g, shape = t.state, t.graph, (rows, cols)
    spec = rk.LatSpec(kind, model, g.offsets,
                      with_reward=kind != "plastic")
    rule = t.plasticity.params if kind == "plastic" \
        else t.reward_modulator.params
    args = dict(
        spec=spec, v=st["v"].reshape(shape),
        w=st["w"].reshape(shape) if "w" in st else torch.zeros(shape),
        lft=st["last_firing_time"].reshape(shape),
        refr=st["refractory_count"].reshape(shape)
        if model in rk.REFRACTORY_MODELS else None,
        weights=g.weights, mask=g.mask, in_deg=g.in_deg,
        params={k: st[k].reshape(shape) for k in rk.MODEL_PARAM_KEYS[model]},
        traces=(t.trace["c"], t.trace["dw"], t.trace["counter"])
        if kind == "mod" else None,
        dopamine=torch.tensor(0.3) if kind != "plastic" else None,
        rule=rule, rewards=np.linspace(0, 0.1, 5).astype(np.float32)
        if kind != "plastic" else None, clock0=7, n_steps=5)
    return args


@pytest.mark.parametrize("kind,model", [("plastic", "lif"),
                                        ("mod", "izhikevich")])
def test_wrapper_on_cpu_runs_the_twin_without_counting(kind, model):
    args = _call_inputs(kind, model)
    v0 = args["v"].clone()
    before = rk.LAUNCHES
    got = rk.lattice_plasticity_steps(**args)
    want = rk.lattice_plasticity_steps_reference(**args)
    assert rk.LAUNCHES == before
    flat = lambda out: [x for o in out for x in (o if isinstance(o, tuple)
                                                 else (o,))]
    for g, w in zip(flat(got), flat(want)):
        if g is None:
            assert w is None
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    torch.testing.assert_close(args["v"], v0, rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    args = _call_inputs("mod", "alif")

    def call(**kw):
        return rk.lattice_plasticity_steps(**{**args, **kw})

    bad = [dict(v=args["v"].double()), dict(lft=args["lft"].long()),
           dict(refr=None), dict(w=args["w"].t()),
           dict(weights=args["weights"][:3]),
           dict(mask=args["mask"].float()), dict(traces=None),
           dict(dopamine=None), dict(rewards=None), dict(n_steps=0),
           dict(spec=args["spec"]._replace(kind="bcm"))]
    for kw in bad:
        with pytest.raises(ValueError):
            call(**kw)
    with pytest.raises(KeyError):
        call(params={k: p for k, p in args["params"].items() if k != "dt"})


def test_gates_mirror_jax():
    """`supports_lattice` and `plain_stdp_lattice_spec` accept what the
    JAX gates accept, without the TPU's 128-column and VMEM limits."""
    for name, (jcls, tcls) in MODELS.items():
        j = snn.RewardModulatedLattice(jcls())
        t = snt.RewardModulatedLattice(tcls(), device="cpu")
        for lat in (j, t):
            lat.populate(6, 5)
        assert not rk.supports_lattice(t) and not jpr.supports_lattice(j)
        for lat in (j, t):
            lat.connect_stencil(radius=1.5)
        assert rk.supports_lattice(t) and jpr.supports_lattice(j)
        t.reward_modulator = snt.STDP()
        assert not rk.supports_lattice(t)
        p = snt.Lattice(tcls(), device="cpu")
        p.populate(6, 5)
        p.connect_stencil(radius=2.0)
        p.do_plasticity = True
        spec = rk.plain_stdp_lattice_spec(p)
        assert spec == rk.LatSpec("plastic", name, p.graph.offsets)
        p.update_grid_history = True
        assert (rk.plain_stdp_lattice_spec(p) is not None) == \
            (name == "izhikevich")
        p.chemical_synapse = True
        assert rk.plain_stdp_lattice_spec(p) is None
    wide = snt.RewardModulatedLattice(snt.Izhikevich(), device="cpu")
    wide.populate(4, 192)
    wide.connect_stencil(radius=2.0)
    assert rk.supports_lattice(wide)
    assert rk.model_kind(object()) is None


def test_routing_and_launch_count():
    """Auto takes the kernel route only on CUDA; a history keeps the
    reward lattice on the plain route; with a graph history the STDP
    lattice takes the plain route with one weight array per step."""
    j = jax_lattice("izhikevich", "mod", 6, 5)
    t = port_of(j, "izhikevich", use_kernel=None)
    t.run_lattice(3)
    assert t._last_run_fused is False
    t.use_kernel = True
    before = rk.LAUNCHES
    t.run_lattice(3)
    assert t._last_run_fused is True and rk.LAUNCHES == before
    t.update_grid_history = True
    t.grid_history = th.EEGHistory()
    t.run_lattice(3)
    assert t._last_run_fused is False and len(t.grid_history.history) == 3
    s = port_of(jax_lattice("izhikevich", "plastic", 6, 5), "izhikevich",
                True)
    s.update_graph_history = True
    w0 = s.graph.weights.numpy().copy()
    s.run_lattice(4)
    assert s._last_run_fused is False and len(s.graph_history) == 4
    assert not np.array_equal(s.graph_history[0], w0)
    np.testing.assert_array_equal(s.graph_history[-1],
                                  s.graph.weights.numpy())


def test_eeg_history_on_stdp_kernel_route_matches_jax():
    j = jax_lattice("izhikevich", "plastic", use_pallas=True)
    j.grid_history = EEGHistory()
    j.update_grid_history = True
    t = port_of(j, "izhikevich", use_kernel=True)
    t.grid_history = th.EEGHistory()
    t.update_grid_history = True
    j.run_lattice(STEPS)
    t.run_lattice(STEPS)
    assert t._last_run_fused == ("stdp", True)
    np.testing.assert_allclose(np.asarray(t.grid_history.history),
                               np.asarray(j.grid_history.history),
                               rtol=RTOL, atol=ATOL)


# -- on a CUDA card only ------------------------------------------------------


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,model", [
    ("plastic", "izhikevich"), ("plastic", "alif"), ("plastic", "lif"),
    ("mod", "izhikevich"), ("mod", "alif"), ("mod", "lif"),
    ("plain", "alif")])
def test_cuda_kernel_matches_twin(kind, model):
    """Built with -fmad=false, the kernels round as the twin does."""
    _needs_cuda()
    args = _call_inputs(kind, model, rows=64, cols=48)
    cuda = {k: (v.cuda() if isinstance(v, torch.Tensor) else
                tuple(x.cuda() for x in v) if isinstance(v, tuple) else v)
            for k, v in args.items()}
    before = rk.LAUNCHES
    got = rk.lattice_plasticity_steps(**cuda)
    torch.cuda.synchronize()
    assert rk.LAUNCHES == before + 1
    want = rk.lattice_plasticity_steps_reference(**cuda)
    names = ("v", "w", "lft", "refr", "spikes", "weights", "traces",
             "dopamine")
    for name, g, w in zip(names, got[:8], want[:8]):
        if g is None:
            continue
        for gx, wx in zip(g if isinstance(g, tuple) else (g,),
                          w if isinstance(w, tuple) else (w,)):
            exact = gx.dtype in (torch.int32, torch.bool) or name == "refr"
            torch.testing.assert_close(gx, wx, rtol=0 if exact else RTOL,
                                       atol=0 if exact else ATOL, msg=name)
    # the fused schedule (the default) and the per-step design: bit-equal
    per_step = rk.lattice_plasticity_steps(**cuda, _per_step=True)
    for name, g, p, w in zip(names, got[:8], per_step[:8], want[:8]):
        assert bits_equal(g, w) and bits_equal(p, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [1, 2, 16, 17])
@pytest.mark.parametrize("kind,model,with_reward", [
    (kind, model, rew) for model in ("izhikevich", "alif", "lif")
    for kind, rew in (("plastic", False), ("mod", True), ("mod", False),
                      ("plain", True))])
def test_cuda_fused_schedule_matches_twin(kind, model, with_reward, n_steps):
    """The fused schedule (K + 1 launches) and the per-step design at K of
    1, 2, 16 and 16 + 1 on a 33 x 70 grid (a width that is not a multiple
    of the 32-column tile, and a partial last tile row), with -0.0
    weights, counters of 2 and emitted voltages: every output bit-equal
    to the twin's, and the launches the C entry counted as designed."""
    _needs_cuda()
    args = schedule_inputs(kind, model, with_reward, 33, 70, seed=n_steps,
                           n_rewards=n_steps, device="cuda")
    args["n_steps"] = n_steps
    before = rk.STEP_LAUNCHES
    got = rk.lattice_plasticity_steps(**args)
    torch.cuda.synchronize()
    assert rk.STEP_LAUNCHES - before == n_steps + (kind != "plain")
    before = rk.STEP_LAUNCHES
    per_step = rk.lattice_plasticity_steps(**args, _per_step=True)
    assert rk.STEP_LAUNCHES - before == rk.step_launches(
        args["spec"], n_steps, per_step=True)
    want = rk.lattice_plasticity_steps_reference(**args)
    for g, p, w in zip(got, per_step, want):
        assert bits_equal(g, w) and bits_equal(p, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,with_reward", [("plastic", False),
                                              ("mod", True)])
def test_cuda_wide_stencil_matches_twin(kind, with_reward):
    """A stencil wider than the kernel's shared-memory halo (offsets up to
    12 apart): its edge pass and phase A read global memory, bit-equal to
    the twin in both designs."""
    _needs_cuda()
    offsets = ((0, 1), (1, 0), (0, -10), (-9, 3), (2, 2), (12, -12))
    args = schedule_inputs(kind, "izhikevich", with_reward, 33, 70, seed=4,
                           n_rewards=17, device="cuda", offsets=offsets)
    args["n_steps"] = 17
    got = rk.lattice_plasticity_steps(**args)
    per_step = rk.lattice_plasticity_steps(**args, _per_step=True)
    want = rk.lattice_plasticity_steps_reference(**args)
    for g, p, w in zip(got, per_step, want):
        assert bits_equal(g, w) and bits_equal(p, w)

"""The model kernel's persistent design (``csrc/model_stencil.cu``
`model_persistent_kernel<M, CPT>`, `ops.model_kernels.persistent_plan`,
`uses_persistent`, `ModelRun`) on the CPU: the residency plan per model
and size, the route rule, the run that `Lattice._run_model` builds once
per run against per-call `model_steps`, and that a run leaves the
caller's planes as they were; on a CUDA card only, both designs against
the plain twin.

Tolerance: bit for bit (floats compared as their int32 bits), as the
kernel and its twin share every association.
"""

import itertools

import numpy as np
import pytest
import torch

import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu_torch.ops import model_kernels as mk
from torch_lattices import bits_equal

torch.set_num_threads(1)

# every kind of the kernel's table (BCMIzhikevich in both normalizations)
KINDS = {
    "lif": snt.LeakyIntegrateAndFire, "qif": snt.QuadraticIntegrateAndFire,
    "alif": snt.AdaptiveLeakyIntegrateAndFire,
    "adex": snt.AdaptiveExpLeakyIntegrateAndFire,
    "dopa": snt.DopaIzhikevich, "leaky_izhikevich": snt.LeakyIzhikevich,
    "bcm": snt.BCMIzhikevich,
    "bcm_chemical": lambda: snt.BCMIzhikevich(chemical_normalization=True),
    "simple_lif": snt.SimpleLeakyIntegrateAndFire,
    "morris_lecar": snt.MorrisLecar,
}
H100_SMS = 132


def random_planes(model, shape, seed, device="cpu"):
    """A call's planes from ``seed``: the model's defaults with every
    parameter plane within 20% of its default, v across the range, random
    spikes, refractory counts and BCM counts (windows of 5 steps), a
    radius-2 stencil with a tenth of the weights -0.0."""
    rows, cols = shape
    rng = np.random.default_rng(seed)
    fields, carry = mk.model_kernel_fields(model)
    g = snt.StencilGraph.build(rows, cols, snt.radius_offsets(2.0),
                               keep_prob=0.8, seed=seed + 1,
                               weight_fn=lambda dr, dc, rr, cc:
                               rng.uniform(0.5, 1.5, rr.shape),
                               device=device)
    g.weights[torch.from_numpy(
        rng.random(tuple(g.weights.shape)) < 0.1).to(device)] = -0.0
    st = model.init_state_host(rows * cols)
    planes = {k: st[k].reshape(shape) for k, _ in fields}
    for k, dt in fields:
        if dt == torch.float32 and k not in carry and k != "v_init":
            planes[k] = (planes[k] * rng.uniform(0.8, 1.2, shape)
                         ).astype(np.float32)
    planes["v"] = rng.uniform(-80.0, 40.0, shape).astype(np.float32)
    planes["is_spiking"] = rng.random(shape) < 0.3
    if "was_increasing" in planes:
        planes["was_increasing"] = rng.random(shape) < 0.5
    if "refractory_count" in planes:
        planes["refractory_count"] = np.where(
            rng.random(shape) < 0.3, rng.integers(1, 5, shape), 0
        ).astype(np.float32)
    if "num_spikes" in planes:
        planes["num_spikes"] = rng.integers(0, 40, shape).astype(np.int32)
        planes["firing_rate_window"] = np.full(shape, 0.5, np.float32)
    lft = np.where(rng.random(shape) < 0.2, 5, -1).astype(np.int32)
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return {k: to(p) for k, p in planes.items()}, to(lft), g


def same(got, want):
    return (all(bits_equal(got[0][k], want[0][k]) for k in want[0])
            and set(got[0]) == set(want[0]) and bits_equal(got[1], want[1])
            and bits_equal(got[2], want[2]))


# -- the plan and the route ---------------------------------------------------


@pytest.mark.parametrize("name", sorted(KINDS))
@pytest.mark.parametrize("shape", [(512, 512), (700, 700), (64, 64),
                                   (2048, 2048)])
def test_plan_per_model_and_size(name, shape):
    """On an H100's 132 SMs with radius 2 (12 offsets): a block owns
    ceil(n / 132) cells rounded up to 32; the weights, wsum and max(in_deg,
    1) come first, then as many parameter planes as fit in 227 KB, in
    field order; none where a block's cells pass its threads' reach or
    the weights do not fit (2048^2: the per-step design)."""
    model = KINDS[name]()
    n = shape[0] * shape[1]
    plan = mk.persistent_plan(model, shape, 12, H100_SMS)
    ins = mk.in_fields(model)
    cap = 32 * -(-(-(-n // H100_SMS)) // 32)
    if cap > mk.max_cpt(model) * mk.THREADS:
        assert plan is None and not mk.uses_persistent(model, shape, 12,
                                                       H100_SMS)
        return
    assert plan.cap == cap and plan.blocks == -(-n // cap)
    assert (plan.blocks - 1) * cap < n <= plan.blocks * cap
    assert plan.resident + plan.streamed == ins
    fit = (mk.SMEM_BUDGET - 4 * cap * 14) // (4 * cap)
    assert len(plan.resident) == min(len(ins), fit)
    assert plan.smem == 4 * cap * (14 + len(plan.resident)) \
        <= mk.SMEM_BUDGET
    assert mk.uses_persistent(model, shape, 12, H100_SMS)


def test_plan_at_the_headline_sizes():
    """512^2: LIF holds its 10 parameter planes (189 KB a block),
    Morris-Lecar 14 of its 15; 700^2: one plane each; 2048^2 and
    BCMIzhikevich at 700^2 (2 cells a thread at most): no plan."""
    lif, ml = snt.LeakyIntegrateAndFire(), snt.MorrisLecar()
    p = mk.persistent_plan(lif, (512, 512), 12, H100_SMS)
    assert (p.blocks, p.cap, len(p.resident), p.streamed) == (131, 2016,
                                                              10, ())
    p = mk.persistent_plan(ml, (512, 512), 12, H100_SMS)
    assert (len(p.resident), p.streamed) == (14, ("leak$v",))
    p = mk.persistent_plan(ml, (700, 700), 12, H100_SMS)
    assert len(p.resident) == 1
    assert mk.persistent_plan(ml, (2048, 2048), 12, H100_SMS) is None
    assert mk.persistent_plan(snt.BCMIzhikevich(), (700, 700), 12,
                              H100_SMS) is None
    assert mk.max_cpt(snt.BCMIzhikevich()) == 2 and mk.max_cpt(ml) == 4


@pytest.mark.parametrize("n_off,want", [(12, True), (64, False)])
def test_route_rule_follows_the_weights(n_off, want):
    """The route is the plan's: 64 offsets of 2016 cells do not fit a
    block's shared memory, so that lattice takes the per-step design."""
    assert mk.uses_persistent(snt.MorrisLecar(), (512, 512), n_off,
                              H100_SMS) is want


def test_call_launches():
    assert mk.call_launches(16, True) == 1
    assert mk.call_launches(17, True) == 2
    assert mk.call_launches(33, True) == 3
    assert mk.call_launches(16, False) == 16


# -- the run of one lattice --------------------------------------------------


@pytest.mark.parametrize("name,calls", [
    (name, calls) for name in sorted(KINDS)
    for calls in ((16, 16, 5), (5, 4, 3))])
def test_run_equals_per_call_model_steps(name, calls):
    """A `ModelRun` over chained calls (the state in its two buffer sets,
    each call writing first the set that does not hold its inputs) equals
    `model_steps` calls each given the last one's outputs, and leaves the
    caller's planes as they were."""
    model = KINDS[name]()
    planes, lft, g = random_planes(model, (9, 13), len(name))
    before = {k: p.clone() for k, p in planes.items()}, lft.clone()
    run = mk.ModelRun(model, planes, lft, g.weights, g.in_deg, g.offsets)
    p, l, clock = dict(planes), lft, 9
    for n in calls:
        got = run.steps(clock, n)
        want = mk.model_steps(model, p, l, g.weights, g.in_deg, g.offsets,
                              clock, n)
        assert same(got, want)
        p, l, clock = dict(p, **want[0]), want[1], clock + n
    assert all(bits_equal(planes[k], before[0][k]) for k in planes)
    assert bits_equal(lft, before[1])


def test_lattice_runs_one_model_run_per_run(monkeypatch):
    """`Lattice.run_lattice` builds one `ModelRun` for its calls and
    leaves the state it started from unmodified."""
    lat = snt.Lattice(snt.MorrisLecar(), device="cpu")
    lat.populate(7, 9, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=7)
    lat.use_kernel = True
    made = []
    orig = mk.ModelRun

    class Spy(orig):
        def __init__(self, *a, **kw):
            made.append(1)
            super().__init__(*a, **kw)

    monkeypatch.setattr(mk, "ModelRun", Spy)
    start = {k: x.clone() for k, x in lat.state.items()}
    old = dict(lat.state)
    lat.run_lattice(37)
    assert made == [1] and lat._last_run_fused == "model"
    assert all(bits_equal(old[k], start[k]) for k in start)
    assert lat.internal_clock == 37


def test_run_checks_its_inputs():
    model = snt.LeakyIntegrateAndFire()
    planes, lft, g = random_planes(model, (5, 6), 1)
    with pytest.raises(ValueError, match="must be a contiguous"):
        mk.ModelRun(model, dict(planes, v=planes["v"].double()), lft,
                    g.weights, g.in_deg, g.offsets)
    run = mk.ModelRun(model, planes, lft, g.weights, g.in_deg, g.offsets)
    with pytest.raises(ValueError, match="n_steps"):
        run.steps(0, 0)
    with pytest.raises(ValueError, match="overflows"):
        run.steps(2**31 - 3, 16)


# -- on a CUDA card only ------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name,per_step", list(itertools.product(
    sorted(KINDS), (False, True))))
def test_cuda_designs_match_twin(name, per_step):
    """Both designs on a 33 x 70 grid over chained calls of K = 1, 2, 16,
    17 and 33 steps: bit-equal to the twin, and 1 launch per 16 steps in
    the persistent design."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    model = KINDS[name]()
    planes, lft, g = random_planes(model, (33, 70), len(name), "cuda")
    run = mk.ModelRun(model, planes, lft, g.weights, g.in_deg, g.offsets,
                      per_step)
    assert (run.plan is None) is per_step
    p, l, clock = dict(planes), lft, 9
    for k in (1, 2, 16, 17, 33):
        before = mk.STEP_LAUNCHES
        got = run.steps(clock, k)
        torch.cuda.synchronize()
        assert mk.STEP_LAUNCHES - before == mk.call_launches(k, not per_step)
        want = mk.model_steps_reference(model, p, l, g.weights, g.in_deg,
                                        g.offsets, clock, k)
        assert same(got, want)
        p, l, clock = dict(p, **want[0]), want[1], clock + k

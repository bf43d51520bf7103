"""The stencil kernel's three designs (``ops.stencil_kernels``: the
persistent design of ``csrc/model_stencil.cu`` kind Izh, the tiled design
and the per-step design of ``csrc/izhikevich_stencil.cu``) on the CPU: the
route rule per shape, stencil and uniformity, the tiled design's streamed
plan (budget, rings, coverage, the card's SMs, the route by reach) and its
schedule replayed on the CPU against the twin (``tests/stream_replay.py``),
the 2-D tiles' invariants, `StencilRun` against per-call `izhikevich_stencil_steps`,
one run per `Lattice.run_lattice` chunk with one uniform check, and the
twin against the JAX package's row-tiled kernel in interpret mode at the
port's plan; on a CUDA card only, each design against the twin
(``tests/test_torch_stencil_cuda.py`` holds the streamed design's).

Tolerance: bit for bit (floats compared as their int32 bits) between the
port's own routes, which share every association; rtol 1e-6, atol 1e-5
against the JAX kernel (XLA's CPU backend may contract or reorder a
multiply-add), as ``tests/test_torch_stencil_kernel.py`` holds it.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.ops import pallas_stencil as jps
from spiking_neural_networks_tpu_torch.ops import model_kernels as mk
from spiking_neural_networks_tpu_torch.ops import stencil_kernels as sk
from torch_lattices import bits_equal
from stream_replay import replay

torch.set_num_threads(1)

H100_SMS = 132
RADIUS2 = snt.radius_offsets(2.0)
# an irregular stencil reaching 12 cells away (chip_smoke.WIDE_OFFSETS)
WIDE_OFFSETS = ((0, 1), (1, 0), (0, -10), (-9, 3), (2, 2), (12, -12))
UNIFORM = dict(a=0.02, b=0.2, c=-55.0, d=8.0, v_th=30.0,
               gap_conductance=10.0, tau_m=1.0, c_m=100.0, dt=0.1)
SCALARS = tuple(UNIFORM[k] for k in sk.PARAM_ORDER)
# the tiles timed against each other at 2048^2 (chip_smoke.TILE_TRIALS)
TILE_TRIALS = ((48, 48, 4), (28, 28, 4), (56, 56, 2), (32, 32, 4),
               (40, 40, 3), (24, 24, 4), (32, 32, 2), (16, 16, 2),
               (16, 16, 1))


def inputs(rows, cols, seed, uniform=True, radius=2.0, offsets=None,
           device="cpu"):
    """One call's planes from ``seed`` (a tenth of the weights -0.0)."""
    rng = np.random.default_rng(seed)
    g = snt.StencilGraph.build(rows, cols, offsets or
                               snt.radius_offsets(radius), keep_prob=0.8,
                               seed=seed + 1, device="cpu")
    weights = g.weights.clone()
    weights[torch.from_numpy(rng.random(tuple(weights.shape)) < 0.1)] = -0.0
    params = {k: torch.full((rows, cols), v) for k, v in UNIFORM.items()}
    if not uniform:
        params["a"] = torch.from_numpy(
            rng.uniform(0.01, 0.03, (rows, cols)).astype(np.float32))
        params["v_th"] = torch.from_numpy(
            rng.uniform(25, 35, (rows, cols)).astype(np.float32))
    t = lambda x: torch.from_numpy(x).to(device)
    return dict(
        v=t(rng.uniform(-65, 30, (rows, cols)).astype(np.float32)),
        w=t(rng.uniform(20, 40, (rows, cols)).astype(np.float32)),
        lft=t(np.where(rng.random((rows, cols)) < 0.2, 5, -1)
              .astype(np.int32)),
        weights=weights.to(device), in_deg=g.in_deg.to(device),
        params={k: p.to(device) for k, p in params.items()},
        offsets=g.offsets)


def args(inp):
    return (inp["v"], inp["w"], inp["lft"], inp["weights"], inp["in_deg"],
            inp["params"], inp["offsets"])


# -- the route rule -----------------------------------------------------------


@pytest.mark.parametrize("shape,uniform,want", [
    ((512, 512), True, "persistent"), ((512, 512), False, "persistent"),
    ((700, 700), True, "persistent"), ((735, 735), False, "persistent"),
    ((736, 736), True, "tiled"), ((1024, 1024), True, "tiled"),
    ((2048, 2048), True, "tiled"), ((4096, 4096), True, "tiled"),
    ((1024, 1024), False, "per_step"), ((2048, 2048), False, "per_step"),
    ((64, 64), True, "persistent"), ((33, 70), False, "persistent")])
def test_route_per_shape_and_uniformity(shape, uniform, want):
    calls = []

    def scalars():
        calls.append(1)
        return SCALARS if uniform else None

    design, plan = sk.route(shape, RADIUS2, H100_SMS, scalars)
    assert design == want
    # the uniform check runs only where the persistent plan cannot hold
    # the weights
    assert len(calls) == (want != "persistent")
    if design == "persistent":
        assert plan == sk.persistent_plan(shape, 12, H100_SMS)
    elif design == "tiled":
        assert plan == sk.stream_plan(shape, RADIUS2, H100_SMS)
    else:
        assert plan is None


def test_route_512_holds_every_parameter_plane():
    plan = sk.persistent_plan((512, 512), 12, H100_SMS)
    assert (plan.blocks, plan.cap) == (131, 2016)
    assert plan.resident == sk.PARAM_ORDER and plan.streamed == ()
    assert plan.smem == 4 * 2016 * (12 + 2 + 9) <= sk.SMEM_BUDGET
    # the weights alone fit up to 735^2 at radius 2
    assert sk.persistent_plan((735, 735), 12, H100_SMS) is not None
    assert sk.persistent_plan((736, 736), 12, H100_SMS) is None


@pytest.mark.parametrize("shape", [(1024, 1024), (2048, 2048), (4096, 4096),
                                   (33, 70)])
def test_wide_stencil_takes_the_per_step_design(shape):
    # beyond the persistent plan (a 1-SM card for the small shape) the
    # tiled design does not take a stencil that reaches past TILE_MAX_PAD
    n_blocks = 1 if shape == (33, 70) else H100_SMS
    assert sk.stencil_pad(WIDE_OFFSETS) == 12 > sk.TILE_MAX_PAD
    assert sk.tile_plan(WIDE_OFFSETS) is None
    design, _ = sk.route(shape, WIDE_OFFSETS, n_blocks, lambda: SCALARS)
    assert design == ("persistent" if sk.persistent_plan(
        shape, len(WIDE_OFFSETS), n_blocks) else "per_step")
    assert sk.route((2048, 2048), WIDE_OFFSETS, H100_SMS,
                    lambda: SCALARS)[0] == "per_step"


@pytest.mark.parametrize("shape", [(512, 512), (2048, 2048), (33, 70)])
def test_per_step_forced(shape):
    called = []
    design, plan = sk.route(shape, RADIUS2, H100_SMS,
                            lambda: called.append(1), design="per_step")
    assert (design, plan, called) == ("per_step", None, [])


def test_forced_designs_that_do_not_apply_raise():
    with pytest.raises(ValueError):
        sk.route((1024, 1024), RADIUS2, H100_SMS, lambda: SCALARS,
                 design="persistent")
    with pytest.raises(ValueError):
        sk.route((512, 512), RADIUS2, H100_SMS, lambda: None,
                 design="tiled")
    with pytest.raises(ValueError):
        sk.route((512, 512), WIDE_OFFSETS, H100_SMS, lambda: SCALARS,
                 design="tiled")
    with pytest.raises(ValueError):
        sk.route((512, 512), RADIUS2, H100_SMS, lambda: SCALARS,
                 design="fast")
    assert sk.route((512, 512), RADIUS2, H100_SMS, lambda: SCALARS,
                    design="tiled")[0] == "tiled"


@pytest.mark.parametrize("design", ["persistent", "per_step", "fast"])
def test_a_tiled_plan_with_another_design_raises(design):
    plan = sk.stream_plan((1024, 1024), RADIUS2, H100_SMS)
    with pytest.raises(ValueError):
        sk.route((1024, 1024), RADIUS2, H100_SMS, lambda: SCALARS,
                 design=design, plan=plan)
    assert sk.route((1024, 1024), RADIUS2, H100_SMS, lambda: SCALARS,
                    design="tiled", plan=plan) == ("tiled", plan)


def test_per_step_forced_on_a_run():
    inp = inputs(12, 20, seed=3)
    run = sk.StencilRun(*args(inp), design="per_step")
    assert (run.design, run.plan) == ("per_step", None)
    got = run.steps(0, 5)
    want = sk.izhikevich_stencil_steps_reference(*args(inp), 0, 5)
    assert all(bits_equal(g, w) for g, w in zip(got[:4], want[:4]))


# -- uniformity ---------------------------------------------------------------


def test_uniform_scalars_reads_every_plane_bitwise():
    inp = inputs(6, 7, seed=1)
    assert sk.uniform_scalars(inp["params"]) == tuple(
        float(np.float32(x)) for x in SCALARS)
    for k in sk.PARAM_ORDER:
        p = dict(inp["params"])
        p[k] = p[k].clone()
        p[k][3, 4] = torch.nextafter(p[k][3, 4], torch.tensor(1e9))
        assert sk.uniform_scalars(p) is None, k
    # -0.0 == 0.0 as floats, but the scalar would give only one of the two
    p = dict(inp["params"])
    p["b"] = torch.zeros(6, 7)
    p["b"][0, 0] = -0.0
    assert sk.uniform_scalars(p) is None
    p["b"] = torch.full((6, 7), -0.0)
    assert sk.uniform_scalars(p)[1] == 0.0


def test_a_lattice_edited_with_apply_leaves_the_tiled_design():
    lat = snt.Lattice(snt.Izhikevich(), device="cpu")
    lat.populate(8, 9, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=7)
    planes = lambda: {k: lat.state[k].reshape(8, 9) for k in sk.PARAM_ORDER}
    assert sk.uniform_scalars(planes()) is not None
    assert sk.route((2048, 2048), lat.graph.offsets, H100_SMS,
                    lambda: sk.uniform_scalars(planes()))[0] == "tiled"
    d = np.random.default_rng(0).uniform(6, 10, 72)
    lat.apply(lambda s: {**s, "d": torch.as_tensor(d, dtype=torch.float32)})
    assert sk.uniform_scalars(planes()) is None
    assert sk.route((2048, 2048), lat.graph.offsets, H100_SMS,
                    lambda: sk.uniform_scalars(planes()))[0] == "per_step"


# -- the tiled design's streamed plan -----------------------------------------

# the main paths' shapes and the sharded composition's blocks (4096^2 over 4
# row shards: interior blocks carry 32 ghost rows on each side, edge blocks
# on one)
STREAM_SHAPES = ((736, 736), (1024, 1024), (2048, 2048), (4096, 4096),
                 (1088, 4096), (1056, 4096), (33, 70), (130, 100), (1, 1))
# every stencil the tiled design takes: the radius discs to 4 and the
# widest the kernel holds (64 offsets of reach 4)
WIDEST_4 = tuple((dr, dc) for dr in range(-4, 5) for dc in range(-4, 5)
                 if (dr, dc) != (0, 0))[:64]
STREAM_STENCILS = {1.0: snt.radius_offsets(1.0), 1.5: snt.radius_offsets(1.5),
                   2.0: RADIUS2, 3.0: snt.radius_offsets(3.0),
                   4.0: snt.radius_offsets(4.0), "widest": WIDEST_4}


@pytest.mark.parametrize("stencil", list(STREAM_STENCILS))
@pytest.mark.parametrize("shape", STREAM_SHAPES)
def test_stream_plan_fits_budget_and_threads(shape, stencil):
    offsets = STREAM_STENCILS[stencil]
    plan = sk.stream_plan(shape, offsets, H100_SMS)
    pad = sk.stencil_pad(offsets)
    assert plan is not None and plan.kb in sk.STREAM_KBS
    assert plan.pad == pad and plan.r == max(pad, 1) and plan.r >= pad
    assert plan.halo == plan.kb * pad and plan.lw == plan.tw + 2 * plan.halo
    assert plan.stride == sk.weight_stride(len(offsets))
    assert plan.smem == sk.stream_smem(plan.kb, plan.r, pad, plan.stride,
                                       plan.lw) <= sk.SMEM_BUDGET
    assert plan.r * plan.lw <= plan.threads <= sk.STREAM_THREADS
    assert plan.threads % 32 == 0 and plan.threads - 32 < plan.r * plan.lw


@pytest.mark.parametrize("kb", sk.STREAM_KBS)
@pytest.mark.parametrize("pad", [0, 1, 2, 3, 4])
def test_stream_rings_hold_kb_pad_plus_r_rows(kb, pad):
    """The weights' ring holds the rows of levels 1..kb and the r rows in
    flight: kb * pad + r at r = pad; the v rings each level's windows and
    newest rows; the smem formula counts them, each v ring twice."""
    r = max(pad, 1)
    wring, v0, lv = sk.stream_rings(kb, r, pad)
    assert wring == (kb + 1) * r and v0 == 3 * r + pad and lv == 2 * r + pad
    if pad:
        assert wring == kb * pad + r
    stride = sk.weight_stride(12)
    assert sk.stream_smem(kb, r, pad, stride, 10) == 4 * 10 * (
        wring * stride + 2 * v0 + (kb - 1) * 2 * lv)


@pytest.mark.parametrize("n_off,want", [(0, 0), (1, 4), (4, 4), (8, 12),
                                        (12, 12), (16, 20), (20, 20),
                                        (28, 28), (48, 52), (64, 68)])
def test_weight_stride_is_an_odd_count_of_16_byte_words(n_off, want):
    assert sk.weight_stride(n_off) == want


@pytest.mark.parametrize("stencil", [1.0, 2.0, 4.0])
@pytest.mark.parametrize("shape", STREAM_SHAPES)
def test_stream_interiors_cover_each_cell_once(shape, stencil):
    """The launch grid's interiors (the C entry's: ceil(cols / tw) x
    ceil(rows / seg) blocks, interiors clipped) partition the lattice."""
    plan = sk.stream_plan(shape, STREAM_STENCILS[stencil], H100_SMS)
    rows, cols = shape
    assert plan.strips == -(-cols // plan.tw)
    assert plan.segments == -(-rows // plan.seg)
    cover = np.zeros(shape, np.int32)
    for by in range(plan.segments):
        for bx in range(plan.strips):
            cover[by * plan.seg:(by + 1) * plan.seg,
                  bx * plan.tw:(bx + 1) * plan.tw] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("shape", [(1024, 1024), (2048, 2048), (4096, 4096),
                                   (1088, 4096), (1056, 4096)])
def test_stream_grid_fills_the_card(shape):
    """One block an SM, in one wave, on at least 9 SMs of 10."""
    plan = sk.stream_plan(shape, RADIUS2, H100_SMS)
    blocks = plan.strips * plan.segments
    assert 0.9 * H100_SMS <= blocks <= H100_SMS
    assert 2 * plan.smem > sk.SMEM_BUDGET      # so one block an SM


def test_stream_plan_falls_back(monkeypatch):
    # past TILE_MAX_PAD nothing tiles; where no strip fits the budget there
    # is no streamed plan, and a reach of 2 to 4 has no other tiled plan:
    # the route falls back to the per-step design
    assert sk.stream_plan((2048, 2048), WIDE_OFFSETS, H100_SMS) is None
    assert sk.tiled_plan((2048, 2048), WIDE_OFFSETS, H100_SMS) is None
    assert sk.stream_plan((2048, 2048), RADIUS2, H100_SMS,
                          budget=2000) is None
    assert sk.tile_plan(RADIUS2) is None
    monkeypatch.setattr(sk, "stream_plan", lambda *a, **k: None)
    assert sk.tiled_plan((2048, 2048), RADIUS2, H100_SMS) is None
    assert sk.route((2048, 2048), RADIUS2, H100_SMS, lambda: SCALARS) \
        == ("per_step", None)
    radius1 = snt.radius_offsets(1.0)
    run = sk.StencilRun(*args(inputs(40, 40, seed=2, radius=1.0)),
                        plan=sk.tile_plan(radius1))
    assert run.design == "tiled" and not run.streamed


@pytest.mark.parametrize("stencil,want", [
    (1.0, "TilePlan"), (1.5, "TilePlan"), (2.0, "StreamPlan"),
    (3.0, "StreamPlan"), (4.0, "StreamPlan"), ("widest", "StreamPlan")])
def test_reach_1_takes_the_2d_tiles(stencil, want):
    """A reach of 1 gives a level too few cells for the streamed plan's
    barriers: its tiled plan is the 2-D tiles'."""
    offsets = STREAM_STENCILS[stencil]
    plan = sk.tiled_plan((2048, 2048), offsets, H100_SMS)
    assert type(plan).__name__ == want
    if want == "TilePlan":
        assert plan == sk.tile_plan(offsets)
    else:
        assert plan == sk.stream_plan((2048, 2048), offsets, H100_SMS)


@pytest.mark.parametrize("shape,stencil,n_sm,k,emit", [
    ((33, 70), 2.0, 6, 17, True), ((20, 23), 1.0, 4, 9, False),
    ((30, 26), 3.0, 5, 7, True), ((26, 31), 4.0, 3, 5, False),
    ((45, 70), 2.0, 7, 16, True), ((37, 29), 1.5, 3, 17, False),
    ((50, 41), "widest", 4, 3, True), ((70, 33), 2.0, 132, 2, False)])
def test_stream_schedule_replay_matches_twin(shape, stencil, n_sm, k, emit):
    """The kernel's schedule (rings, levels, carried state), replayed on
    the CPU with each slot checked for the row it holds, gives the twin's
    bits at the plan the card would take."""
    offsets = STREAM_STENCILS[stencil]
    inp = inputs(*shape, seed=3, offsets=offsets)
    plan = sk.stream_plan(shape, offsets, n_sm)
    got = replay(plan, *args(inp), 40, k, emit)
    want = sk.izhikevich_stencil_steps_reference(*args(inp), 40, k, emit)
    assert all(bits_equal(g, x) for g, x in zip(got[:4], want[:4]))
    if emit:
        assert bits_equal(got[4], want[4])


@pytest.mark.parametrize("kb", sk.STREAM_KBS)
def test_stream_replay_partial_strips_and_segments(kb):
    """Strips and segments that do not divide the lattice: the last of
    each is clipped."""
    inp = inputs(37, 50, seed=6)
    halo = kb * 2
    tw, seg = 16, 10
    lw = tw + 2 * halo
    plan = sk.StreamPlan(kb, 2, 2, tw, seg, halo, lw, 12, 4, 4,
                         32 * -(-2 * lw // 32),
                         sk.stream_smem(kb, 2, 2, 12, lw))
    got = replay(plan, *args(inp), 3, 17, True)
    want = sk.izhikevich_stencil_steps_reference(*args(inp), 3, 17, True)
    assert all(bits_equal(g, x) for g, x in zip(got, want))


@pytest.mark.parametrize("ring", [0, 1, 2])
def test_stream_replay_catches_a_shallow_ring(monkeypatch, ring):
    """Each ring one row shallower than `stream_rings` gives: the replay
    finds a slot overwritten before its last read."""
    real = sk.stream_rings

    def shallow(kb, r, pad):
        depth = list(real(kb, r, pad))
        depth[ring] -= 1
        return tuple(depth)

    inp = inputs(45, 70, seed=3)
    plan = sk.stream_plan((45, 70), RADIUS2, 7)
    monkeypatch.setattr(sk, "stream_rings", shallow)
    with pytest.raises(AssertionError):
        replay(plan, *args(inp), 40, 16)


# -- the tiled design's tiles -------------------------------------------------


@pytest.mark.parametrize("radius", [1.0, 2.0, 3.0])
@pytest.mark.parametrize("tile", TILE_TRIALS + ((24, 40, 3), (5, 7, 5)))
def test_tile_config_invariants(radius, tile):
    offsets = snt.radius_offsets(radius)
    plan = sk.tile_config(*tile, offsets)
    pad = sk.stencil_pad(offsets)
    halo = tile[2] * pad
    cells = (tile[0] + 2 * halo) * (tile[1] + 2 * halo)
    smem = 4 * cells * (len(offsets) + 2)
    if plan is None:
        assert smem > sk.SMEM_BUDGET \
            or cells > sk.TILE_MAX_CPT * sk.TILE_THREADS
        return
    assert plan.halo == halo and (plan.lh, plan.lw) == (
        tile[0] + 2 * halo, tile[1] + 2 * halo)
    assert plan.smem == smem <= sk.SMEM_BUDGET
    assert 1 <= plan.cpt <= sk.TILE_MAX_CPT
    assert plan.threads % 32 == 0 and plan.threads <= sk.TILE_THREADS
    assert plan.threads * plan.cpt >= cells
    # the fewest cells a thread that the block's threads hold
    assert plan.cpt == 1 or (plan.cpt - 1) * sk.TILE_THREADS < cells


@pytest.mark.parametrize("radius,fits", [
    (1.0, True), (1.5, True), (2.0, False), (3.0, False), (4.0, False)])
def test_tile_plan_fits_the_budget(radius, fits):
    """The 2-D tile `TILE` takes every stencil of a reach of at most 1,
    within the budget; a farther reach has no 2-D tile."""
    offsets = snt.radius_offsets(radius)
    plan = sk.tile_plan(offsets)
    if not fits:
        assert plan is None
        return
    assert plan is not None and plan.smem <= sk.SMEM_BUDGET
    assert (plan.th, plan.tw, plan.kb) == sk.TILE
    assert plan.halo == plan.kb * sk.stencil_pad(offsets)


def test_tile_plan_radius_2_is_48_by_48_at_4_steps():
    # radius 2 streams; the 2-D tile it would take (chip_smoke times it
    # beside the streamed plan) fills the budget
    assert sk.tile_plan(RADIUS2) is None
    plan = sk.tile_config(*sk.TILE, RADIUS2)
    assert (plan.th, plan.tw, plan.kb, plan.halo) == (48, 48, 4, 8)
    assert (plan.lh, plan.lw, plan.cpt, plan.threads) == (64, 64, 4, 1024)
    assert plan.smem == 229376


@pytest.mark.parametrize("shape", [(2048, 2048), (4096, 4096), (1024, 1024),
                                   (33, 70), (130, 100), (1, 1)])
@pytest.mark.parametrize("tile", [sk.TILE, (32, 32, 2), (16, 16, 2),
                                  (28, 28, 4), (24, 40, 3)])
def test_tiles_cover_every_cell_exactly_once(shape, tile):
    """The launch grid's interiors partition the lattice (the C entry's
    grid: ceil(cols / tw) x ceil(rows / th) blocks, interiors clipped)."""
    rows, cols = shape
    th, tw, _ = tile
    cover = np.zeros(shape, np.int32)
    for by in range(-(-rows // th)):
        for bx in range(-(-cols // tw)):
            cover[by * th:(by + 1) * th, bx * tw:(bx + 1) * tw] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("n_steps,design,want", [
    (16, "persistent", 1), (17, "persistent", 2), (1, "persistent", 1),
    (16, "tiled", 4), (7, "tiled", 2), (17, "tiled", 5), (1, "tiled", 1),
    (16, "per_step", 16), (7, "per_step", 7)])
def test_call_launches(n_steps, design, want):
    assert sk.call_launches(n_steps, design,
                            sk.tile_plan(snt.radius_offsets(1.0))) == want


# -- StencilRun against the per-call wrapper ----------------------------------


@pytest.mark.parametrize("design", ["persistent", "tiled", "per_step"])
@pytest.mark.parametrize("emit", [False, True])
def test_stencil_run_equals_per_call_wrapper(design, emit):
    inp = inputs(11, 13, seed=4, uniform=design == "tiled")
    before = (sk.LAUNCHES, sk.STEP_LAUNCHES)
    run = sk.StencilRun(*args(inp), design=design)
    assert run.design == design
    v, w, lft = inp["v"], inp["w"], inp["lft"]
    clock = 30
    for k in (16, 7, 1):
        got = run.steps(clock, k, emit)
        want = sk.izhikevich_stencil_steps(
            v, w, lft, inp["weights"], inp["in_deg"], inp["params"],
            inp["offsets"], clock, k, emit)
        assert all(bits_equal(g, x) for g, x in zip(got[:4], want[:4]))
        if emit:
            assert got[4].shape == (k, 11, 13) and bits_equal(got[4], want[4])
        else:
            assert got[4] is None and want[4] is None
        v, w, lft = want[0], want[1], want[2]
        clock += k
    # the caller's planes are untouched, and the CPU counts no launch
    again = inputs(11, 13, seed=4, uniform=design == "tiled")
    assert all(bits_equal(inp[k], again[k]) for k in ("v", "w", "lft"))
    assert (sk.LAUNCHES, sk.STEP_LAUNCHES) == before


@pytest.mark.parametrize("cur,writes,want", [
    (None, 1, (0, 0)), (None, 4, (0, 1)), (0, 1, (1, 1)), (0, 2, (1, 0)),
    (1, 1, (0, 0)), (1, 16, (0, 1)), (1, 5, (0, 0))])
def test_stencil_run_buffers_alternate(cur, writes, want):
    """A call writes first the set that does not hold its inputs, and the
    writes alternate from there (`model_kernels.next_sets`)."""
    assert mk.next_sets(cur, writes) == want


def test_cpu_run_chains_the_twins_outputs():
    """On CPU tensors a run holds each call's outputs, the twin's own
    tensors, as the next call's inputs, and allocates no buffer sets."""
    inp = inputs(9, 10, seed=5)
    run = sk.StencilRun(*args(inp))
    first = run.steps(0, 16)
    assert not hasattr(run.sets, "bufs")
    assert run.sets.state[0]["v"] is first[0]
    assert run.sets.state[1] is first[2]
    second = run.steps(16, 7)
    want = sk.izhikevich_stencil_steps_reference(
        first[0], first[1], first[2], inp["weights"], inp["in_deg"],
        inp["params"], inp["offsets"], 16, 7)
    assert all(bits_equal(g, w) for g, w in zip(second[:4], want[:4]))


def test_stencil_run_rejects_what_the_kernel_does_not_take():
    inp = inputs(8, 8, seed=6)
    with pytest.raises(ValueError):
        sk.StencilRun(inp["v"].double(), *args(inp)[1:])
    run = sk.StencilRun(*args(inp))
    with pytest.raises(ValueError):
        run.steps(0, 0)
    with pytest.raises(ValueError):
        run.steps(2**31 - 3, 16)


def test_cpu_run_reports_the_h100_route():
    assert sk.StencilRun(*args(inputs(8, 8, seed=7))).design == "persistent"


# -- the runner ---------------------------------------------------------------


def _lattice(rows, cols, device="cpu", use_kernel=True):
    lat = snt.Lattice(snt.Izhikevich(), device=device)
    lat.populate(rows, cols, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=7)
    v0 = np.random.default_rng(1).uniform(-65.0, 30.0, rows * cols)
    lat.apply(lambda s: {**s, "v": torch.as_tensor(
        v0, dtype=torch.float32, device=lat.device)})
    lat.use_kernel = use_kernel
    return lat


@pytest.mark.parametrize("history", [False, True])
def test_one_stencil_run_per_chunk_and_one_uniform_check(monkeypatch,
                                                         history):
    # on a 1-SM card a 72 x 72 lattice is past the persistent plan, so each
    # run considers the tiled design and checks uniformity
    monkeypatch.setattr(sk, "CPU_SM_COUNT", 1)
    runs, checks = [], []
    real_run, real_check = sk.StencilRun, sk.uniform_scalars

    class Counted(real_run):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self.design)

    def counted_check(params):
        checks.append(1)
        return real_check(params)

    monkeypatch.setattr(sk, "StencilRun", Counted)
    monkeypatch.setattr(sk, "uniform_scalars", counted_check)
    lat = _lattice(72, 72)
    lat.update_grid_history = history
    lat.history_chunk = 32 if history else None
    lat.run_lattice(80)
    chunks = 3 if history else 1
    assert runs == ["tiled"] * chunks and len(checks) == chunks
    assert lat._last_run_fused == ("kernel", history)
    assert lat.internal_clock == 80
    if history:
        assert np.stack(lat.grid_history.history).shape == (80, 72, 72)


def test_runner_matches_chained_twin():
    lat = _lattice(10, 12)
    st0 = {k: v.clone() for k, v in lat.state.items()}
    lat.run_lattice(37)
    shape = (10, 12)
    params = {k: st0[k].reshape(shape) for k in sk.PARAM_ORDER}
    v, w, lft = (st0[k].reshape(shape) for k in ("v", "w",
                                                 "last_firing_time"))
    g = lat.graph
    clock = 0
    for k in (16, 16, 5):
        v, w, lft, spk, _ = sk.izhikevich_stencil_steps_reference(
            v, w, lft, g.weights, g.in_deg, params, g.offsets, clock, k)
        clock += k
    assert bits_equal(lat.state["v"], v.reshape(-1))
    assert bits_equal(lat.state["w"], w.reshape(-1))
    assert bits_equal(lat.state["last_firing_time"], lft.reshape(-1))
    assert bits_equal(lat.state["is_spiking"], spk.reshape(-1))


# -- the twin against the JAX row-tiled kernel at the port's tile -------------


@pytest.mark.parametrize("n_steps", [None, 3])
def test_twin_matches_jax_tiled_kernel_at_the_ports_tile(n_steps):
    """The JAX kernel tiles rows only; at the port's streamed plan on a
    2-SM card (one strip, two segments of ``seg`` rows, halo kb x pad,
    kb steps a launch) it runs with ``seg``-row tiles.  Fewer steps than
    kb (3) keep the same halo."""
    rows, cols = 96, 128
    plan = sk.stream_plan((rows, cols), RADIUS2, 2)
    assert (plan.strips, plan.segments, plan.seg) == (1, 2, rows // 2)
    k = plan.kb if n_steps is None else n_steps
    inp = inputs(rows, cols, seed=8)
    wst_ov, ind_ov = jps.tiled_overlap_weights(
        jnp.asarray(inp["weights"].numpy()),
        jnp.asarray(inp["in_deg"].numpy()), plan.seg, plan.halo)
    pvec = jnp.asarray(SCALARS, jnp.float32)
    v, w, lft, spk = jps.fused_izhikevich_multistep_tiled(
        jnp.asarray(inp["v"].numpy()), jnp.asarray(inp["w"].numpy()),
        jnp.asarray(inp["lft"].numpy()), wst_ov, ind_ov, pvec, 40,
        offsets=inp["offsets"], n_steps=k, tile_r=plan.seg, halo=plan.halo)
    run = sk.StencilRun(*args(inp), plan=plan)
    assert (run.design, run.plan, run.streamed) == ("tiled", plan, True)
    tv, tw, tlft, tspk, _ = run.steps(40, k)
    np.testing.assert_allclose(tv.numpy(), np.asarray(v), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(w), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_array_equal(tlft.numpy(), np.asarray(lft))
    np.testing.assert_array_equal(tspk.numpy(), np.asarray(spk) > 0)
    # the streamed schedule itself gives the twin's bits here
    got = replay(plan, *args(inp), 40, k)
    assert all(bits_equal(g, x) for g, x in zip(got[:4], (tv, tw, tlft,
                                                         tspk)))


# -- on a CUDA card only ------------------------------------------------------


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["persistent", "tiled", "per_step"])
@pytest.mark.parametrize("shape", [(33, 70), (130, 100), (256, 256)])
@pytest.mark.parametrize("radius", [1.0, 2.0, 3.0])
@pytest.mark.parametrize("emit", [False, True])
def test_cuda_design_matches_twin(design, shape, radius, emit):
    """Chained calls of K = 1, 2, 7, 16 and 17 steps on one run: bit for
    bit, the launches the C entry counted equal to `call_launches`."""
    _needs_cuda()
    inp = inputs(*shape, seed=9, uniform=design == "tiled", radius=radius,
                 device="cuda")
    run = sk.StencilRun(*args(inp), design=design)
    v, w, lft, clock = inp["v"], inp["w"], inp["lft"], 100
    for k in (1, 2, 7, 16, 17):
        before = sk.STEP_LAUNCHES
        got = run.steps(clock, k, emit)
        torch.cuda.synchronize()
        assert sk.STEP_LAUNCHES - before == run.launches(k)
        want = sk.izhikevich_stencil_steps_reference(
            v, w, lft, inp["weights"], inp["in_deg"], inp["params"],
            inp["offsets"], clock, k, emit)
        assert all(bits_equal(g, x) for g, x in zip(got[:4], want[:4]))
        if emit:
            assert bits_equal(got[4], want[4])
        v, w, lft = want[0], want[1], want[2]
        clock += k


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["persistent", "tiled", "per_step"])
def test_cuda_run_buffers_alternate(design):
    """What `model_kernels.next_sets` promises: a call writes first the
    set that does not hold its inputs, and its outputs lie in the set it
    ends on, never in the caller's planes.  (Two consecutive calls may
    end on one set: a call of an even number of launches ends on the set
    that held its inputs.)"""
    _needs_cuda()
    inp = inputs(9, 10, seed=5, device="cuda")
    run = sk.StencilRun(*args(inp), design=design)
    caller = {inp["v"].data_ptr(), inp["w"].data_ptr(),
              inp["lft"].data_ptr()}
    for k, n in ((0, 16), (16, 7), (23, 1), (24, 2)):
        cur = run.sets.cur
        first, out = mk.next_sets(cur, run.launches(n))
        assert first != cur
        v, w, lft = run.steps(k, n)[:3]
        assert run.sets.cur == out
        assert v.data_ptr() == run.sets.bufs["v"][out].data_ptr()
        assert w.data_ptr() == run.sets.bufs["w"][out].data_ptr()
        assert lft.data_ptr() == run.sets.lft_buf[out].data_ptr()
        assert not caller & {v.data_ptr(), w.data_ptr(), lft.data_ptr()}


@pytest.mark.cuda
@pytest.mark.parametrize("tile", TILE_TRIALS + ((24, 40, 3),))
def test_cuda_tiles_match_twin(tile):
    _needs_cuda()
    inp = inputs(130, 100, seed=10, device="cuda")
    run = sk.StencilRun(*args(inp), plan=sk.tile_config(*tile, inp["offsets"]))
    got = run.steps(5, 17, True)
    want = sk.izhikevich_stencil_steps_reference(*args(inp), 5, 17, True)
    assert all(bits_equal(g, x) for g, x in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,want", [((512, 512), "persistent"),
                                        ((1024, 1024), "tiled")])
def test_cuda_runner_routes(shape, want):
    _needs_cuda()
    lat = _lattice(*shape, device="cuda", use_kernel=None)
    before = dict(sk.DESIGN_CALLS)
    lat.run_lattice(32)
    torch.cuda.synchronize()
    assert sk.DESIGN_CALLS[want] == before[want] + 2

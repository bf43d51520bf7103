"""The stencil kernel's tiled design, streamed plan, on a card (``cuda``
marker; skips without one): `izh_tiled_kernel_rows` against the plain twin,
bit for bit, on 33 x 70, 130 x 100, 256^2, 736^2 and a block of the sharded
composition (4096 columns, 1024 rows and 32 ghost rows each side), radius
1 to 4, chained calls of K = 1, 2, 7, 16 and 17 on one `StencilRun`,
emitting and not, with the launches the C entry counted; the 2048^2
main path through the streamed plan; and the radius-2 table of the
kernel's own instantiation.  No JAX here: the file runs on the
machine with the card.

    python -m pytest --noconftest -m cuda tests/test_torch_stencil_cuda.py
"""

import numpy as np
import pytest
import torch

import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu_torch.ops import stencil_kernels as sk

UNIFORM = dict(a=0.02, b=0.2, c=-55.0, d=8.0, v_th=30.0,
               gap_conductance=10.0, tau_m=1.0, c_m=100.0, dt=0.1)


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def bits_equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool((a == b).all())


def inputs(rows, cols, seed, radius):
    """One call's planes on the card from ``seed`` (a tenth of the weights
    -0.0), uniform parameters."""
    rng = np.random.default_rng(seed)
    g = snt.StencilGraph.build(rows, cols, snt.radius_offsets(radius),
                               keep_prob=0.8, seed=seed + 1, device="cpu")
    weights = g.weights.clone()
    weights[torch.from_numpy(rng.random(tuple(weights.shape)) < 0.1)] = -0.0
    t = lambda x: torch.from_numpy(x).cuda()
    return dict(
        v=t(rng.uniform(-65, 30, (rows, cols)).astype(np.float32)),
        w=t(rng.uniform(20, 40, (rows, cols)).astype(np.float32)),
        lft=t(np.where(rng.random((rows, cols)) < 0.2, 5, -1)
              .astype(np.int32)),
        weights=weights.cuda(), in_deg=g.in_deg.cuda(),
        params={k: torch.full((rows, cols), v, device="cuda")
                for k, v in UNIFORM.items()},
        offsets=g.offsets)


@pytest.mark.cuda
@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("radius", [1.0, 2.0, 3.0, 4.0])
@pytest.mark.parametrize("shape", [(33, 70), (130, 100), (256, 256),
                                   (736, 736), (1088, 4096)])
def test_streamed_design_matches_twin(shape, radius, emit):
    _needs_cuda()
    inp = inputs(*shape, seed=9, radius=radius)
    args = (inp["v"], inp["w"], inp["lft"], inp["weights"], inp["in_deg"],
            inp["params"], inp["offsets"])
    plan = sk.stream_plan(shape, inp["offsets"],
                          sk.model_kernels.sm_count(inp["v"].device))
    run = sk.StencilRun(*args, plan=plan)
    assert run.streamed and run.design == "tiled"
    assert run.plan == sk.tiled_plan(shape, inp["offsets"],
                                     sk.model_kernels.sm_count(
                                         inp["v"].device)) or radius == 1.0
    v, w, lft, clock = inp["v"], inp["w"], inp["lft"], 100
    for k in (1, 2, 7, 16, 17):
        before = (sk.STEP_LAUNCHES, sk.STREAMED_CALLS)
        got = run.steps(clock, k, emit)
        torch.cuda.synchronize()
        assert sk.STEP_LAUNCHES - before[0] == run.launches(k) \
            == -(-k // run.plan.kb)
        assert sk.STREAMED_CALLS - before[1] == 1
        want = sk.izhikevich_stencil_steps_reference(
            v, w, lft, inp["weights"], inp["in_deg"], inp["params"],
            inp["offsets"], clock, k, emit)
        assert all(bits_equal(g, x) for g, x in zip(got[:4], want[:4]))
        if emit:
            assert bits_equal(got[4], want[4])
        v, w, lft = want[0], want[1], want[2]
        clock += k


@pytest.mark.cuda
def test_main_path_takes_the_streamed_plan():
    _needs_cuda()
    lat = snt.Lattice(snt.Izhikevich())
    lat.populate(2048, 2048, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=7)
    before = (sk.DESIGN_CALLS["tiled"], sk.STREAMED_CALLS)
    lat.run_lattice(32)
    torch.cuda.synchronize()
    assert sk.DESIGN_CALLS["tiled"] - before[0] == 2
    assert sk.STREAMED_CALLS - before[1] == 2


@pytest.mark.cuda
def test_the_kernels_radius_2_table_is_the_disc():
    """The C entry gives the radius-2 disc, in radius_offsets' order, its
    own instantiation (compile-time column offsets): its table, which the
    kernel and the C entry share, must be that disc."""
    _needs_cuda()
    import ctypes
    from spiking_neural_networks_tpu_torch import _build
    dr, dc = (ctypes.c_int * 12)(), (ctypes.c_int * 12)()
    _build.load().izh_stencil_r2(dr, dc)
    assert tuple(zip(dr, dc)) == snt.radius_offsets(2.0)

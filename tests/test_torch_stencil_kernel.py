"""The stencil kernel's plain twin against each of the three TPU kernels it
replaces (run in interpret mode on the CPU), the wrapper's CPU route and
checks, and, on a CUDA card only, the CUDA kernel against the twin.

Tolerance: rtol 1e-6, atol 1e-5 on v and w with lft and spikes equal, the
tolerance the JAX package's own kernel tests hold: the twin and the TPU
kernels compute the same association, and differ only where XLA's CPU
backend contracts or reorders a multiply-add.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spiking_neural_networks_tpu.ops import graph as jg
from spiking_neural_networks_tpu.ops import pallas_stencil as jps
from spiking_neural_networks_tpu.models.integrate_and_fire import (
    Izhikevich as JIzhikevich)
from spiking_neural_networks_tpu_torch.ops import stencil_kernels as sk
from spiking_neural_networks_tpu_torch.ops.graph import (
    SparseGraph, StencilGraph)
from spiking_neural_networks_tpu_torch.models.integrate_and_fire import (
    Izhikevich as TIzhikevich)

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-5
UNIFORM = dict(a=0.02, b=0.2, c=-55.0, d=8.0, v_th=30.0,
               gap_conductance=10.0, tau_m=1.0, c_m=100.0, dt=0.1)


def make_inputs(rows, cols, seed, uniform=True, keep_prob=0.8):
    """NumPy planes for one lattice: v, w, lft, graph and the 9 params."""
    rng = np.random.default_rng(seed)
    g = jg.StencilGraph.build(rows, cols, jg.radius_offsets(2.0),
                              keep_prob=keep_prob, seed=seed + 1)
    v = rng.uniform(-65, 30, (rows, cols)).astype(np.float32)
    w = rng.uniform(20, 40, (rows, cols)).astype(np.float32)
    lft = np.where(rng.random((rows, cols)) < 0.2, 5, -1).astype(np.int32)
    params = {k: np.full((rows, cols), val, np.float32)
              for k, val in UNIFORM.items()}
    if not uniform:
        params["a"] = rng.uniform(0.01, 0.03, (rows, cols)).astype(np.float32)
        params["d"] = rng.uniform(6, 10, (rows, cols)).astype(np.float32)
        params["v_th"] = rng.uniform(25, 35, (rows, cols)).astype(np.float32)
    return dict(v=v, w=w, lft=lft, weights=np.array(g.weights),
                in_deg=np.array(g.in_deg), params=params,
                offsets=g.offsets)


def twin(inp, clock0, n_steps, emit=False, device="cpu"):
    t = {k: torch.from_numpy(inp[k]).to(device)
         for k in ("v", "w", "lft", "weights", "in_deg")}
    params = {k: torch.from_numpy(p).to(device)
              for k, p in inp["params"].items()}
    return sk.izhikevich_stencil_steps_reference(
        t["v"], t["w"], t["lft"], t["weights"], t["in_deg"], params,
        inp["offsets"], clock0, n_steps, emit)


def jax_params(inp):
    return [jnp.asarray(inp["params"][k]) for k in sk.PARAM_ORDER]


def close(got, want):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_twin_matches_per_step_kernel():
    inp = make_inputs(16, 16, seed=1, uniform=False)
    v, w, spk = jps.fused_izhikevich_stencil_step(
        jnp.asarray(inp["v"]), jnp.asarray(inp["w"]),
        jnp.asarray(inp["weights"]), jnp.asarray(inp["in_deg"]),
        *jax_params(inp), offsets=inp["offsets"], tile_r=8)
    tv, tw, tlft, tspk, _ = twin(inp, clock0=3, n_steps=1)
    close(tv, v)
    close(tw, w)
    np.testing.assert_array_equal(tspk.numpy(), np.asarray(spk) > 0)
    np.testing.assert_array_equal(
        tlft.numpy(), np.where(np.asarray(spk) > 0, 3, inp["lft"]))


@pytest.mark.parametrize("emit", [False, True])
def test_twin_matches_multistep_kernel(emit):
    inp = make_inputs(16, 16, seed=2, uniform=False)
    out = jps.fused_izhikevich_multistep(
        jnp.asarray(inp["v"]), jnp.asarray(inp["w"]),
        jnp.asarray(inp["lft"]), jnp.asarray(inp["weights"]),
        jnp.asarray(inp["in_deg"]), *jax_params(inp), 100,
        offsets=inp["offsets"], n_steps=16, emit=("v",) if emit else ())
    tv, tw, tlft, tspk, tvpre = twin(inp, clock0=100, n_steps=16, emit=emit)
    close(tv, out[0])
    close(tw, out[1])
    np.testing.assert_array_equal(tlft.numpy(), np.asarray(out[2]))
    np.testing.assert_array_equal(tspk.numpy(), np.asarray(out[3]) > 0)
    assert (tlft.numpy() >= 100).any()
    if emit:
        assert tvpre.shape == (16, 16, 16)
        close(tvpre, out[4])
    else:
        assert tvpre is None


def test_twin_matches_tiled_kernel():
    inp = make_inputs(64, 128, seed=3, uniform=True)
    wst_ov, ind_ov = jps.tiled_overlap_weights(
        jnp.asarray(inp["weights"]), jnp.asarray(inp["in_deg"]), 32, 8)
    pvec = jnp.asarray([UNIFORM[k] for k in sk.PARAM_ORDER], jnp.float32)
    v, w, lft, spk = jps.fused_izhikevich_multistep_tiled(
        jnp.asarray(inp["v"]), jnp.asarray(inp["w"]),
        jnp.asarray(inp["lft"]), wst_ov, ind_ov, pvec, 40,
        offsets=inp["offsets"], n_steps=4, tile_r=32, halo=8)
    tv, tw, tlft, tspk, _ = twin(inp, clock0=40, n_steps=4)
    close(tv, v)
    close(tw, w)
    np.testing.assert_array_equal(tlft.numpy(), np.asarray(lft))
    np.testing.assert_array_equal(tspk.numpy(), np.asarray(spk) > 0)


def test_wrapper_on_cpu_runs_the_twin_without_counting():
    inp = make_inputs(12, 20, seed=4, uniform=False)
    t = {k: torch.from_numpy(inp[k]) for k in ("v", "w", "lft", "weights",
                                              "in_deg")}
    params = {k: torch.from_numpy(p) for k, p in inp["params"].items()}
    before = sk.LAUNCHES
    got = sk.izhikevich_stencil_steps(
        t["v"], t["w"], t["lft"], t["weights"], t["in_deg"], params,
        inp["offsets"], 7, 5, emit=True)
    want = twin(inp, 7, 5, emit=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert sk.LAUNCHES == before
    # the inputs are left as they were
    np.testing.assert_array_equal(t["v"].numpy(), inp["v"])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    inp = make_inputs(8, 8, seed=5)
    t = {k: torch.from_numpy(inp[k]) for k in ("v", "w", "lft", "weights",
                                              "in_deg")}
    params = {k: torch.from_numpy(p) for k, p in inp["params"].items()}

    def call(**kw):
        args = dict(v=t["v"], w=t["w"], lft=t["lft"], weights=t["weights"],
                    in_deg=t["in_deg"], params=params,
                    offsets=inp["offsets"], clock0=0, n_steps=2)
        args.update(kw)
        return sk.izhikevich_stencil_steps(**args)

    with pytest.raises(ValueError):
        call(v=t["v"].double())
    with pytest.raises(ValueError):
        call(lft=t["lft"].long())
    with pytest.raises(ValueError):
        call(w=t["w"].t())                      # not contiguous
    with pytest.raises(ValueError):
        call(weights=t["weights"][:3])          # planes != offsets
    with pytest.raises(ValueError):
        call(n_steps=0)
    with pytest.raises(KeyError):
        call(params={k: p for k, p in params.items() if k != "dt"})
    many = tuple((dr, dc) for dr in range(-4, 5) for dc in range(-4, 5))
    with pytest.raises(ValueError):
        call(offsets=many, weights=torch.zeros((len(many), 8, 8)))


def test_supports_mirrors_jax_gate():
    jgraph = jg.StencilGraph.build(4, 4, jg.radius_offsets(1.0))
    tsg = StencilGraph.build(4, 4, jg.radius_offsets(1.0))
    tgraph = SparseGraph.empty(16)
    for el, ch, pl in [(True, False, False), (True, True, False),
                       (False, False, False), (True, False, True)]:
        assert sk.supports(TIzhikevich(), tsg, el, ch, pl) == \
            jps.supports(JIzhikevich(), jgraph, el, ch, pl)
        assert not sk.supports(TIzhikevich(), tgraph, el, ch, pl)


# -- on a CUDA card only ------------------------------------------------------


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n_steps,emit,uniform", [
    ((64, 64), 1, False, True), ((64, 64), 16, True, True),
    ((130, 100), 16, True, False), ((256, 256), 16, False, False)])
def test_cuda_kernel_matches_twin(shape, n_steps, emit, uniform):
    """Built with -fmad=false, the kernel rounds as the twin does: equal."""
    _needs_cuda()
    inp = make_inputs(*shape, seed=6, uniform=uniform)
    t = {k: torch.from_numpy(inp[k]).cuda() for k in ("v", "w", "lft",
                                                     "weights", "in_deg")}
    params = {k: torch.from_numpy(p).cuda() for k, p in inp["params"].items()}
    before = sk.LAUNCHES
    got = sk.izhikevich_stencil_steps(
        t["v"], t["w"], t["lft"], t["weights"], t["in_deg"], params,
        inp["offsets"], 100, n_steps, emit)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == before + 1
    want = twin(inp, 100, n_steps, emit, device="cuda")
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=0)
    if emit:
        torch.testing.assert_close(got[4], want[4], rtol=RTOL, atol=ATOL)

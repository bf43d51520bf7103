"""The flat-mode arm of the network kernels against the TPU kernel it
replaces, ``pallas_reward._fused_chunk`` in its flat (1, N) form (run in
interpret mode on the CPU), on the dense networks of
``tests/test_pallas_chem.py`` (`_dense_net`: two 60-neuron lattices with
random dense intra graphs, a dense block between them and a Rate train);
the gate; the wrapper's CPU route and checks; `_seg_dot`; and, on a CUDA
card only, the CUDA kernels against the twin.

Tolerance: rtol 1e-5, atol 1e-4 on v, w and the chemical fields with
firing times and spikes equal, as the JAX package's own flat-mode tests
hold its kernel against its XLA path: the TPU kernel takes the dense sums
as MXU products, the twin as 32 partial sums in a fixed order.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
from spiking_neural_networks_tpu.ops.graph import DenseGraph as JDenseGraph
from spiking_neural_networks_tpu_torch.convert import network_from
from spiking_neural_networks_tpu_torch.core.structured import (
    nt_flags, resolve_structured_plan)
from spiking_neural_networks_tpu_torch.ops import network_kernels as nk
from test_pallas_chem import _chem_net, _dense_net
from test_torch_chem_network import (RTOL, ATOL, assert_chem_networks_match)
from torch_networks import both

torch.set_num_threads(1)

# The small networks are 48 wide: a narrower random block has few enough
# column offsets to be classified as a resample connection.


def firing_dense_net(chemical, n=60):
    """`_dense_net` never fires within its tests' 121 steps; here a third
    of each lattice starts above threshold, the train weighs 100 and the
    dense block 20, and the chemical form's AMPA receptors get the raised
    conductance and reversal (25, 60 mV) of `_chem_net`, so that spikes
    after the seeded ones, firing times, release and the dense chemical
    gathers are exercised."""
    net = _dense_net(n=n, chemical=chemical)
    rng = np.random.default_rng(12)
    for lat in net.lattices.values():
        v = np.asarray(lat.state["v"]).copy()
        v[rng.permutation(n)[:n // 3]] = 40.0
        s = {**lat.state, "v": jnp.asarray(v)}
        if chemical:
            s["rec$g"] = s["rec$g"].at[:, 0].set(25.0)
            s["rec$e"] = s["rec$e"].at[:, 0].set(60.0)
        lat.state = s
    for key, weight in (((2, 0), 100.0), ((0, 1), 20.0)):
        src, dst, w = net.connections[key]
        net.connections[key] = (src, dst,
                                np.full_like(np.asarray(w), weight))
    return net


# -- the twin against the TPU kernel ------------------------------------------

FORMS = [(_dense_net, False, 121), (_dense_net, True, 90),
         (firing_dense_net, False, 121), (firing_dense_net, True, 90)]
FORM_IDS = ["electrical", "chemical", "electrical-firing", "chemical-firing"]


@pytest.mark.parametrize("build,chemical,steps", FORMS, ids=FORM_IDS)
def test_twin_matches_tpu_kernel(build, chemical, steps):
    """`_dense_net` at n = 60 and its firing form: the twin
    (use_kernel=True on the CPU) against `_fused_chunk` in interpret mode
    (use_pallas=True)."""
    j, t = both(lambda: build(chemical=chemical), True, True)
    j.run_lattices(steps)
    t.run_lattices(steps)
    assert j._last_run_fused is True
    assert t._last_run_fused == ("flat-chemical" if chemical else "flat",
                                 False)
    assert_chem_networks_match(t, j)
    if build is firing_dense_net:
        for lid in ((0, 1) if chemical else (0,)):
            lft = t.lattices[lid].state["last_firing_time"]
            assert (lft > 0).any(), "no spike after the seeded ones"
        if chemical:
            assert t.lattices[1].state["rec$r"].max() > 0
            assert t.lattices[1].state["nt$t"].max() > 0


@pytest.mark.parametrize("build,chemical,steps", FORMS, ids=FORM_IDS)
def test_plain_route_matches_jax_xla(build, chemical, steps):
    j, t = both(lambda: build(chemical=chemical), False, False)
    j.run_lattices(steps)
    t.run_lattices(steps)
    assert not j._last_run_fused and t._last_run_fused is False
    assert_chem_networks_match(t, j)


def test_twin_matches_tpu_kernel_with_history_and_edgeless_lattice():
    """A flat network whose second lattice has no intra edge (an empty
    `DenseGraph`) and whose first records a grid history: the history is
    rebuilt in the user's (rows, cols) from the emitted (1, N) rows."""
    def build():
        net = _dense_net(n=48)
        for lat in net.lattices.values():
            lat.rows, lat.cols = 6, 8           # the same 48 nodes as a grid
        net.lattices[1].graph = JDenseGraph.empty(48)
        net.lattices[0].update_grid_history = True
        return net
    j, t = both(build, True, True)
    j.run_lattices(40)
    t.run_lattices(40)
    assert j._last_run_fused is True and t._last_run_fused == ("flat", True)
    assert_chem_networks_match(t, j)
    hj = np.stack([np.asarray(x) for x in j.lattices[0].grid_history.history])
    ht = np.stack(t.lattices[0].grid_history.history)
    assert ht.shape == hj.shape == (40, 6, 8)
    np.testing.assert_allclose(ht, hj, rtol=RTOL, atol=ATOL)


# -- the gate -----------------------------------------------------------------


def _route(net, steps=3):
    t = network_from(net, "cpu")
    t.use_kernel = True
    t.run_lattices(steps)
    return t._last_run_fused


def _with_stencil():
    net = _dense_net(n=48)
    net.lattices[1].connect_stencil(radius=1.0)
    return net


def _with_resample():
    net = _dense_net(n=48)
    pool = snn.Lattice(net.lattices[0].model, id=4)
    pool.populate(1, 24, gap_conductance=10.0)
    net.add_lattice(pool)
    net.connect_vectorized(0, 4, lambda pr, pc, qr, qc: np.where(
        pc // 2 == qc, 0.5, np.nan))
    return net


def _with_513():
    net = _dense_net(n=48)
    big = snn.Lattice(net.lattices[0].model, id=4)
    big.populate(1, 513, gap_conductance=10.0)
    net.add_lattice(big)
    return net


def _wide_block():
    """No dense graph, but a dense block whose source side is 513 wide."""
    net = _chem_net(rows=1, cols=48)
    big = snn.Lattice(net.lattices[0].model, id=4)
    big.populate(1, 513, gap_conductance=10.0)
    net.add_lattice(big)
    net.connect_vectorized(4, 1, lambda pr, pc, qr, qc: np.where(
        (pc * 7 + qc * 3) % 5 == 0, 0.5, np.nan))
    return net


@pytest.mark.parametrize("build", [
    _with_stencil, _with_resample, lambda: _dense_net(n=48, plastic=True),
    _with_513, _wide_block],
    ids=["stencil", "resample", "plastic", "n513", "block513"])
def test_gate_sends_mixed_layouts_to_the_plain_route(build):
    """Dense beside a stencil graph, a resample connection or a plastic
    lattice, and a lattice or block side above `DENSE_N_MAX`: the plain
    route, as in the JAX gate."""
    assert _route(build()) is False


def test_gate_takes_flat_mode():
    assert _route(_dense_net(n=48)) == ("flat", False)
    assert _route(_dense_net(n=48, chemical=True)) == ("flat-chemical", False)
    assert nk.DENSE_N_MAX == 512


def test_dense_block_between_edgeless_lattices_is_flat():
    """No dense graph at all: a dense block alone switches the layout."""
    def build():
        net = _dense_net(n=48)
        for lat in net.lattices.values():
            lat.graph = JDenseGraph.empty(48)
        return net
    j, t = both(build, True, True)
    j.run_lattices(33)
    t.run_lattices(33)
    assert j._last_run_fused is True and t._last_run_fused == ("flat", False)
    assert_chem_networks_match(t, j)


def test_empty_connection_keeps_its_slot():
    """A connection with no edge is dropped from the spec; its weights
    pass through the flat route."""
    def build():
        net = _dense_net(n=48, chemical=True)
        net.connect(1, 0, lambda x, y: x[0] > 10**6, lambda x, y: 1.0)
        return net
    j, t = both(build, True, True)
    j.run_lattices(40)
    t.run_lattices(40)
    assert j._last_run_fused is True
    assert t._last_run_fused == ("flat-chemical", False)
    assert_chem_networks_match(t, j)
    plan = resolve_structured_plan(t)
    kinds = [c["op"].kind for c in plan["conns"]]
    assert kinds == ["dense", "empty", "one2one"]
    assert t.connections[(1, 0)][2].shape == (0,)


# -- the wrapper and the twin's sum -------------------------------------------


def _call_args(n_steps=5, chemical=True, n=48):
    t = network_from(_dense_net(n=n, chemical=chemical), "cpu")
    plan = resolve_structured_plan(t)
    flags = nt_flags(t, plan)
    n_lat = len(plan["lat_ids"])
    spec = nk.plain_network_spec(t, plan, not any(flags), flags[n_lat:])
    lats, trains, conns = nk.member_inputs(spec, t, plan)
    return dict(spec=spec, lats=lats, trains=trains, conns=conns,
                uniforms=[None for _ in spec.trains],
                rule=t._plasticity().params, clock0=7, n_steps=n_steps)


def _flat(out):
    lat, tr, cn, extra = out
    assert extra is None
    xs = []
    for d in lat:
        for key, x in d.items():
            if key == "chem" and x is not None:
                xs += [y for _, y in sorted(x.items())]
            elif x is not None:
                xs.append(x)
    return xs + [x for d in tr for x in d.values() if x is not None] \
        + list(cn)


def test_spec_of_a_flat_network():
    spec = _call_args()["spec"]
    assert [ls.graph for ls in spec.lattices] == ["dense", "dense"]
    assert [ls.shape for ls in spec.lattices] == [(1, 48), (1, 48)]
    assert [ts.shape for ts in spec.trains] == [(1, 48)]
    assert sorted(cs.op for cs in spec.conns) == [("dense",), ("one2one",)]
    assert nk.is_flat(spec)


@pytest.mark.parametrize("chemical", [False, True])
def test_wrapper_on_cpu_runs_the_twin_without_counting(chemical):
    args = _call_args(chemical=chemical)
    counts = nk.LAUNCHES, nk.CHEM_LAUNCHES, nk.FLAT_LAUNCHES
    got = nk.network_steps(**args)
    want = nk.network_steps_reference(**args)
    assert (nk.LAUNCHES, nk.CHEM_LAUNCHES, nk.FLAT_LAUNCHES) == counts
    for g, w in zip(_flat(got), _flat(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert got[0][0]["v"].shape == (1, 48)


def test_wrapper_rejects_what_flat_mode_does_not_take():
    args = _call_args()
    spec = args["spec"]

    def call(**kw):
        return nk.network_steps(**{**args, **kw})

    def lat(k, **kw):
        lats = [dict(d) for d in args["lats"]]
        lats[k].update(kw)
        return dict(lats=lats)

    def lat_spec(k, **kw):
        ls = list(spec.lattices)
        ls[k] = ls[k]._replace(**kw)
        return dict(spec=spec._replace(lattices=tuple(ls)))

    dense_ci = [cs.op for cs in spec.conns].index(("dense",))
    conns = list(spec.conns)
    conns[dense_ci] = conns[dense_ci]._replace(post_plastic=True)
    w0 = args["lats"][0]["weights"]
    bad = [lat(0, weights=w0[:, :47].contiguous()),
           lat(0, mask=args["lats"][0]["mask"].float()),
           lat(1, weights=None),
           lat_spec(0, kind="plastic"),
           lat_spec(0, shape=(6, 8)),
           lat_spec(1, offsets=((0, 1),)),
           dict(spec=spec._replace(conns=tuple(conns))),
           dict(conns=[dict(c, w=c["w"].reshape(-1)) if i == dense_ci else c
                       for i, c in enumerate(args["conns"])])]
    for kw in bad:
        with pytest.raises((ValueError, KeyError)):
            call(**kw)


@pytest.mark.parametrize("n_src", [9, 32, 37, 64, 100])
def test_seg_dot_sums_in_the_kernels_order(n_src):
    """The twin's dense sum: bit-equal to scalar float32 loops in the CUDA
    kernel's order (partial sum k over the sources k, k + 32, ..., then
    the partial sums in the order of k), whatever the width's remainder."""
    rng = np.random.default_rng(n_src)
    x = rng.uniform(-70, 30, (4, n_src)).astype(np.float32)
    w = rng.normal(0, 1, (n_src, 29)).astype(np.float32)
    want = np.zeros((4, 29), np.float32)
    for k in range(nk.DENSE_SEG):
        part = np.zeros((4, 29), np.float32)
        for i in range(k, n_src, nk.DENSE_SEG):
            part = part + x[:, i, None] * w[i]
        want = want + part
    got = nk._seg_dot(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)
    one = nk._seg_dot(torch.from_numpy(x[:1]), torch.from_numpy(w))
    np.testing.assert_array_equal(one.numpy(), want[:1])
    np.testing.assert_allclose(got.numpy(), x @ w, rtol=1e-5, atol=1e-4)


def test_twin_takes_a_dense_block_from_a_train():
    """A train that feeds a dense block (its effects are the sources; the
    subtracted term is exactly 0): the twin against the plain route."""
    def build():
        net = _dense_net(n=48, chemical=False)
        mask = np.random.default_rng(3).random((48, 48)) < 0.2
        net.connect(2, 1, lambda x, y: bool(mask[x[1], y[1]]),
                    lambda x, y: 4.0)
        return net
    j, t = both(build, False, True)
    j.run_lattices(60)
    t.run_lattices(60)
    assert t._last_run_fused == ("flat", False)
    spec = nk.plain_network_spec(t, resolve_structured_plan(t), True, (False,))
    assert any(cs.op == ("dense",) and cs.pre_is_st for cs in spec.conns)
    assert_chem_networks_match(t, j)


# -- on a CUDA card only ------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("chemical", [False, True])
@pytest.mark.parametrize("n_steps", [16, 7])
def test_cuda_flat_arm_matches_twin(n_steps, chemical):
    """Built with -fmad=false, the flat arm sums and rounds as the twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    args = _call_args(n_steps, chemical, n=60)

    def cuda(x):
        if isinstance(x, torch.Tensor):
            return x.cuda()
        if isinstance(x, dict):
            return {k: cuda(v) for k, v in x.items()}
        return x

    args.update(lats=[cuda(d) for d in args["lats"]],
                trains=[cuda(d) for d in args["trains"]],
                conns=[cuda(d) for d in args["conns"]])
    before = nk.FLAT_LAUNCHES
    got = nk.network_steps(**args)
    torch.cuda.synchronize()
    assert nk.FLAT_LAUNCHES == before + 1
    want = nk.network_steps_reference(**args)
    for g, w in zip(_flat(got), _flat(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("chemical", [False, True])
@pytest.mark.parametrize("n_steps", [16, 7, 37])
def test_cuda_persistent_and_per_step_designs_match_twin(monkeypatch,
                                                          n_steps,
                                                          chemical):
    """The flat arm through the persistent kernel with every member
    resident in shared memory and with every member streamed, and through
    the per-step design, each bit for bit; 37 steps take three
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    args = _call_args(n_steps, chemical, n=60)

    def cuda(x):
        if isinstance(x, torch.Tensor):
            return x.cuda()
        if isinstance(x, dict):
            return {k: cuda(v) for k, v in x.items()}
        return x

    args.update(lats=[cuda(d) for d in args["lats"]],
                trains=[cuda(d) for d in args["trains"]],
                conns=[cuda(d) for d in args["conns"]])
    assert nk.uses_persistent(args["spec"])
    want = nk.network_steps_reference(**args)
    budget = nk.SMEM_BUDGET
    for smem, per_step in ((budget, False), (0, False), (budget, True)):
        monkeypatch.setattr(nk, "SMEM_BUDGET", smem)   # 0: all streamed
        before = (nk.FLAT_LAUNCHES, nk.PERSISTENT_LAUNCHES)
        got = nk.network_steps(**args, per_step=per_step)
        torch.cuda.synchronize()
        assert (nk.FLAT_LAUNCHES, nk.PERSISTENT_LAUNCHES) == (
            before[0] + 1, before[1] + (not per_step))
        assert len(_flat(got)) == len(_flat(want))
        for g, w in zip(_flat(got), _flat(want)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)

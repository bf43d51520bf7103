"""The network kernels' plain twin against the TPU kernel they replace,
``pallas_reward._fused_chunk`` in its grid-mode plain-network form (run in
interpret mode on the CPU), through both packages' entry points and, for
Poisson trains, call for call on injected uniforms; the gate, the
wrapper's CPU route and checks; and, on a CUDA card only, the CUDA kernels
against the twin.

Tolerance: rtol 1e-6, atol 1e-5 on v, w, weights and histories, with
firing times, spikes and refractory counts equal.  The twin and the TPU
kernel compute the same association; they part where XLA's CPU backend and
PyTorch round an exp or fold a division differently (XLA turns the train
effect's ``-1 / (k / dt)`` into ``-dt / k``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
from spiking_neural_networks_tpu.core import structured as jsr
from spiking_neural_networks_tpu.core.history import HISTORY_KINDS
from spiking_neural_networks_tpu.ops import pallas_reward as jpr
from spiking_neural_networks_tpu_torch.core import structured as tsr
from spiking_neural_networks_tpu_torch.ops import network_kernels as nk
from torch_networks import (assert_networks_match, both, mixed_net,
                            plain_net)

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-5
STEPS = 37                      # two K=16 calls and a remainder of 5
NETS = {"alif": lambda: plain_net("alif"),
        "lif": lambda: plain_net("lif"),
        "izhikevich-exp": lambda: plain_net(
            "izhikevich", refractoriness="exponential_decay"),
        "mixed": lambda: mixed_net(v0=(-60.0, 50.0))}


@pytest.mark.parametrize("name", sorted(NETS))
def test_twin_matches_tpu_kernel(name):
    """8x8 networks (mixed: 8x8 / 4x4 with pooling and upsampling), 37
    steps: the twin (use_kernel=True on the CPU) against `_fused_chunk` in
    interpret mode (use_pallas=True).  Weights move and neurons fire."""
    j, t = both(NETS[name], True, True)
    before = both(NETS[name], True, True)[1]
    j.run_lattices(STEPS)
    t.run_lattices(STEPS)
    assert j._last_run_fused is True
    assert t._last_run_fused == ("network", False)
    assert_networks_match(t, j, RTOL, ATOL)
    for lid, jl in j.lattices.items():
        if "refractory_count" in jl.state:
            np.testing.assert_array_equal(
                t.lattices[lid].state["refractory_count"].numpy(),
                np.asarray(jl.state["refractory_count"]))
    assert (t.lattices[0].state["last_firing_time"] > 3).any()
    assert max(np.abs(t.connections[k][2] - before.connections[k][2]).max()
               for k in t.connections) > 1e-2
    assert np.abs(t.lattices[0].graph.weights.numpy()
                  - before.lattices[0].graph.weights.numpy()).max() > 1e-2


@pytest.mark.parametrize("kind", ["grid", "average", "eeg", "spikes"])
def test_twin_matches_tpu_kernel_with_emitted_history(kind):
    """The excitatory lattice's history rides along as emitted pre-reset v
    and is rebuilt outside the kernel; 21 steps (16 and 5)."""
    j, t = both(lambda: mixed_net(hist=HISTORY_KINDS[kind]()), True, True)
    j.run_lattices(21)
    t.run_lattices(21)
    assert j._last_run_fused is True
    assert t._last_run_fused == ("network", True)
    assert_networks_match(t, j, RTOL, ATOL)
    hj = j.lattices[0].grid_history.history
    ht = t.lattices[0].grid_history.history
    assert len(ht) == len(hj) == 21
    if kind == "spikes":
        np.testing.assert_array_equal(np.stack(ht), np.stack(hj))
    else:
        np.testing.assert_allclose(np.asarray(ht), np.asarray(hj), rtol=RTOL,
                                   atol=ATOL)


def _jax_call(jnet, n_steps, uniforms):
    """One `_fused_chunk` call of the JAX network's grid-mode spec, built as
    `plain_network_runner` builds it, on the given per-train uniforms
    ((n_steps * rows, cols) each)."""
    jnet._ship_states()
    plan = jsr.resolve_structured_plan(jnet)
    lats = [jnet.lattices[i] for i in plan["lat_ids"]]
    sts = [jnet.spike_train_lattices[i] for i in plan["st_ids"]]
    lat_index = {i: k for k, i in enumerate(plan["lat_ids"])}
    st_index = {i: k for k, i in enumerate(plan["st_ids"])}
    lspecs = tuple(jpr.LatSpec("plastic" if l.do_plasticity else "plain",
                               l.graph.offsets, jpr._model_kind(l.model),
                               (l.rows, l.cols)) for l in lats)
    tspecs = tuple(jpr._train_spec(s, sts[0].model) for s in sts)
    cspecs, ops = [], []
    for c in plan["conns"]:
        pre_st = c["pre_is_st"]
        pre = st_index[c["pre"]] if pre_st else lat_index[c["pre"]]
        post = lat_index[c["post"]]
        pre_plastic = not pre_st and lspecs[pre].kind == "plastic"
        post_plastic = lspecs[post].kind == "plastic"
        kind = c["op"].kind
        cspecs.append(jpr.ConnSpec(
            pre_st, pre, post, False, 0, pre_plastic, post_plastic,
            pre_plastic or post_plastic,
            kind if isinstance(kind, tuple) else ("one2one",)))
        ops.append(c["op"])
    spec = jpr.NetSpec(lspecs, tspecs, tuple(cspecs), False)
    lat_data = tuple(jpr._lat_data(spec, k, l.state, l.graph, None)
                     for k, l in enumerate(lats))
    tr_data = tuple(jpr._train_data(s.state, s.rows, s.cols, ts=ts)
                    for s, ts in zip(sts, tspecs))
    cn_data = tuple(jpr._conn_data(op.w0, op.aux, *lspecs[cs.post].shape,
                                   None, cs.op)
                    for op, cs in zip(ops, cspecs))
    pp = jnet._plasticity().params
    pp_vec = jnp.stack([jnp.float32(pp[k]) for k in jpr.PP_KEYS])
    flat = jpr._flat_inputs(spec, n_steps, lat_data, tr_data, cn_data, 0.0,
                            jnet.internal_clock,
                            jnp.zeros((n_steps,), jnp.float32),
                            tuple(jnp.asarray(u) for u in uniforms), pp_vec,
                            jnp.ones((len(jpr.RP_KEYS),), jnp.float32))
    outs = jpr._fused_chunk(spec, n_steps, flat)
    return jpr._unflatten(spec, outs, lat_data, tr_data, cn_data)


def _port_inputs(t):
    plan = tsr.resolve_structured_plan(t)
    spec = nk.plain_network_spec(t, plan, not any(tsr.nt_flags(t, plan)))
    return (spec, *nk.member_inputs(spec, t, plan))


@pytest.mark.parametrize("n_steps", [16, 5])
def test_twin_matches_tpu_kernel_on_injected_uniforms(n_steps):
    """Poisson trains: the TPU kernel (through `_flat_inputs` and
    `_fused_chunk`) and the twin read the same uniforms, so they must agree
    call for call."""
    j = mixed_net("poisson", hertz=400.0)
    t = snn_to_port(j)
    rng = np.random.default_rng(9)
    u = rng.random((n_steps, 8, 8)).astype(np.float32)
    jl, jt, jc, _, jspk, jtspk, _ = _jax_call(j, n_steps,
                                               [u.reshape(n_steps * 8, 8)])
    spec, lats, trains, conns = _port_inputs(t)
    tl, tt, tc, _ = nk.network_steps(spec, lats, trains, conns,
                                  [torch.from_numpy(u)],
                                  t._plasticity().params, t.internal_clock,
                                  n_steps)
    for k, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a["v"].numpy(), np.asarray(b.v),
                                   rtol=RTOL, atol=ATOL, err_msg=f"v{k}")
        np.testing.assert_allclose(a["w"].numpy(), np.asarray(b.w),
                                   rtol=RTOL, atol=ATOL, err_msg=f"w{k}")
        np.testing.assert_array_equal(a["lft"].numpy(), np.asarray(b.lft))
        np.testing.assert_array_equal(a["spikes"].numpy(),
                                      np.asarray(jspk[k]) > 0.0)
        if spec.lattices[k].kind == "plastic":
            np.testing.assert_allclose(a["weights"].numpy(),
                                       np.asarray(b.wst), rtol=RTOL,
                                       atol=ATOL)
    np.testing.assert_array_equal(tt[0]["lft"].numpy(),
                                  np.asarray(jt[0].lft))
    np.testing.assert_array_equal(tt[0]["spikes"].numpy(),
                                  np.asarray(jtspk[0]) > 0.0)
    assert tt[0]["spikes"].any() or (tt[0]["lft"] >= 3).any()
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b.w).reshape(
            a.shape), rtol=RTOL, atol=ATOL)


def snn_to_port(j):
    from spiking_neural_networks_tpu_torch.convert import network_from
    t = network_from(j, "cpu")
    t.use_kernel = True
    return t


def _route(build, use_kernel=True):
    """The port's and the JAX package's route tags after one step."""
    j, t = both(build, True, use_kernel)
    t.run_lattices(1)
    j.run_lattices(1)
    return t._last_run_fused, bool(j._last_run_fused)


def test_gate_routes_as_jax_does():
    """Which configurations take the kernel route, on both packages."""
    def with_train(model):
        def build():
            net = mixed_net()
            st = snn.SpikeTrainLattice(model, id=2)
            st.populate(8, 8)
            net.spike_train_lattices[2] = st
            return net
        return build

    def edit(fn):
        def build():
            net = mixed_net()
            fn(net)
            return net
        return build

    def train_history(net):
        net.spike_train_lattices[2].update_grid_history = True

    def graph_history(net):
        net.lattices[1].update_graph_history = True

    def neurotransmitter(net):
        lat = net.lattices[1]
        lat.state = lat.model.insert_neurotransmitter(lat.state, "AMPA")

    def dense(net):
        # an irregular connection: a dense block
        net.connect(0, 1, lambda x, y: (x[0] * 3 + y[1]) % 5 == 0,
                    lambda x, y: 0.1)

    def edgeless(net):
        lat = snn.Lattice(snn.Izhikevich(), id=4)
        lat.populate(4, 4, gap_conductance=10.0)
        net.add_lattice(lat)
        net.connect(1, 4, lambda x, y: x == y, lambda x, y: 3.0)

    cases = [(mixed_net, ("network", False), True),
             (with_train(snn.PresetSpikeTrain()), False, False),
             (edit(train_history), False, False),
             (edit(graph_history), False, False),
             (edit(neurotransmitter), False, False),
             (edit(dense), False, False),
             (edit(edgeless), ("network", False), True),
             (lambda: plain_net("alif", rows=4, cols=160), ("network", False),
              False)]          # no 128-column limit on CUDA
    for build, port_tag, jax_tag in cases:
        assert _route(build) == (port_tag, jax_tag)
    hist_alif = lambda: plain_net("alif")
    j, t = both(hist_alif, True, True)
    t.lattices[0].update_grid_history = True
    t.run_lattices(2)
    assert t._last_run_fused is False       # ALIF emits no v_pre
    _, t = both(mixed_net, True, None)
    t.run_lattices(2)
    assert t._last_run_fused is False       # auto: the kernel only on CUDA


def test_gate_bounds_incoming_connections():
    def build():
        lat = snn.Lattice(snn.LeakyIntegrateAndFire(), id=0)
        lat.populate(4, 4)
        lat.connect_stencil(radius=1.0)
        trains = []
        for k in range(nk.MAX_IN + 1):
            st = snn.SpikeTrainLattice(snn.RateSpikeTrain(), id=10 + k)
            st.populate(4, 4, rate=0.5)
            trains.append(st)
        net = snn.LatticeNetwork.generate_network([lat], trains)
        for st in trains:
            net.connect(st.id, 0, lambda x, y: x == y, lambda x, y: 2.0)
        return net

    j, t = both(build, False, True)
    t.run_lattices(3)
    assert t._last_run_fused is False
    del t.spike_train_lattices[10 + nk.MAX_IN]
    del t.connections[(10 + nk.MAX_IN, 0)]
    t._conn_version += 1
    t.run_lattices(3)
    assert t._last_run_fused == ("network", False)


def _call_args(n_steps=5):
    _, t = both(lambda: mixed_net("poisson"), False, True)
    spec, lats, trains, conns = _port_inputs(t)
    u = [torch.rand((n_steps, *ts.shape), generator=torch.Generator()
                    .manual_seed(1)) for ts in spec.trains]
    return dict(spec=spec, lats=lats, trains=trains, conns=conns,
                uniforms=u, rule=t._plasticity().params, clock0=3,
                n_steps=n_steps)


def _flat(out):
    lat, tr, cn, extra = out
    assert extra is None
    return ([x for d in lat for x in d.values() if x is not None]
            + [x for d in tr for x in d.values() if x is not None]
            + list(cn))


def test_wrapper_on_cpu_runs_the_twin_without_counting():
    args = _call_args()
    v0 = args["lats"][0]["v"].clone()
    w0 = args["conns"][2]["w"].clone()
    before = nk.LAUNCHES
    got = nk.network_steps(**args)
    want = nk.network_steps_reference(**args)
    assert nk.LAUNCHES == before
    for g, w in zip(_flat(got), _flat(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    torch.testing.assert_close(args["lats"][0]["v"], v0, rtol=0, atol=0)
    torch.testing.assert_close(args["conns"][2]["w"], w0, rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    args = _call_args()
    spec = args["spec"]

    def call(**kw):
        return nk.network_steps(**{**args, **kw})

    def lat(k, **kw):
        lats = [dict(d) for d in args["lats"]]
        lats[k].update(kw)
        return dict(lats=lats)

    bad = [lat(0, v=args["lats"][0]["v"].double()),
           lat(0, lft=args["lats"][0]["lft"].long()),
           lat(1, w=args["lats"][1]["w"].t()),
           lat(0, weights=args["lats"][0]["weights"][:3]),
           lat(0, mask=args["lats"][0]["mask"].float()),
           dict(uniforms=[args["uniforms"][0][:2]]), dict(uniforms=[]),
           dict(n_steps=0), dict(clock0=2**31 - 3),
           dict(conns=args["conns"][:2]),
           dict(spec=spec._replace(lattices=(
               spec.lattices[0]._replace(kind="mod"),) + spec.lattices[1:])),
           dict(spec=spec._replace(conns=(
               spec.conns[0]._replace(op=("dense",)),) + spec.conns[1:])),
           dict(spec=spec._replace(conns=spec.conns[:2] + (
               spec.conns[2]._replace(pre_plastic=True),))),
           dict(spec=spec._replace(conns=spec.conns[:1] + (
               spec.conns[1]._replace(op=spec.conns[1].op[:5] + (0,)
                                      + spec.conns[1].op[6:]),)
               + spec.conns[2:]))]
    for kw in bad:
        with pytest.raises(ValueError):
            call(**kw)
    params = {k: p for k, p in args["lats"][0]["params"].items() if k != "dt"}
    with pytest.raises(KeyError):
        call(**lat(0, params=params))
    many = spec._replace(conns=spec.conns + (spec.conns[0],) * nk.MAX_IN)
    with pytest.raises(ValueError, match="at most"):
        call(spec=many, conns=args["conns"]
             + [args["conns"][0]] * nk.MAX_IN)


# -- on a CUDA card only ------------------------------------------------------


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [16, 7])
def test_cuda_kernels_match_twin(n_steps, monkeypatch):
    """Built with -fmad=false, the kernels round as the twin does: the
    persistent kernel with every member resident in shared memory and
    with every member streamed, and the per-step design, each bit for
    bit."""
    _needs_cuda()
    args = _call_args(n_steps)
    cuda = lambda d: {k: (v.cuda() if isinstance(v, torch.Tensor) else
                          {q: p.cuda() for q, p in v.items()}
                          if isinstance(v, dict) else v)
                      for k, v in d.items()}
    args.update(lats=[cuda(d) for d in args["lats"]],
                trains=[cuda(d) for d in args["trains"]],
                conns=[cuda(d) for d in args["conns"]],
                uniforms=[u.cuda() for u in args["uniforms"]])
    assert nk.uses_persistent(args["spec"])
    want = nk.network_steps_reference(**args)
    budget = nk.SMEM_BUDGET
    for smem, per_step in ((budget, False), (0, False), (budget, True)):
        monkeypatch.setattr(nk, "SMEM_BUDGET", smem)   # 0: all streamed
        before = (nk.LAUNCHES, nk.PERSISTENT_LAUNCHES)
        got = nk.network_steps(**args, per_step=per_step)
        torch.cuda.synchronize()
        assert (nk.LAUNCHES, nk.PERSISTENT_LAUNCHES) == (
            before[0] + 1, before[1] + (not per_step))
        assert len(_flat(got)) == len(_flat(want))
        for g, w in zip(_flat(got), _flat(want)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)

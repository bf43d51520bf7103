"""The chemical arm of the network kernels against the TPU kernel it
replaces, ``pallas_reward._fused_chunk`` in its chemical grid-mode form
(run in interpret mode on the CPU): through both packages' entry points on
the configurations of ``tests/test_pallas_chem.py`` and, for Poisson
trains, call for call on injected uniforms; `kernel_log` and `kernel_pow`;
the wrapper's CPU route and checks; and, on a CUDA card only, the CUDA
kernels against the twin.

Tolerance: rtol 1e-5, atol 1e-4 on v, w, concentrations, gating values,
currents and modifiers, with firing times and spikes equal: the twin and
the TPU kernel compute the same association, but the twin's exp and pow
(`kernel_exp`, `kernel_pow`, float operations only) are within an ulp or
a few of XLA's, not bit-equal, and the receptor currents (~1e3) carry it.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
from spiking_neural_networks_tpu.core import structured as jsr
from spiking_neural_networks_tpu.ops import pallas_reward as jpr
from spiking_neural_networks_tpu_torch.convert import network_from
from spiking_neural_networks_tpu_torch.core import structured as tsr
from spiking_neural_networks_tpu_torch.core.plasticity import (
    kernel_log, kernel_pow)
from spiking_neural_networks_tpu_torch.ops import network_kernels as nk
from test_torch_chem_network import (CONFIGS, RTOL, ATOL,
                                     assert_chem_networks_match)
from torch_networks import both, chem_net

torch.set_num_threads(1)

STEPS = 121
KERNEL_CONFIGS = [name for name in CONFIGS if name != "resample"]


# -- kernel_log and kernel_pow ------------------------------------------------


def test_kernel_log_is_within_an_ulp():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(1e-6, 10, 4000),
                        np.exp(rng.uniform(-87, 88, 4000)),
                        [1e-40, 1.17549435e-38, 0.5, 1.0, 2.0, 3.4e38]])
    x = x.astype(np.float32)
    got = kernel_log(torch.from_numpy(x)).numpy().astype(np.float64)
    want = np.log(x.astype(np.float64))
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    big = np.abs(want) > 1e-2
    assert (np.abs(got - want)[big] <= ulp[big]).all()
    assert np.abs(got - want)[~big].max() < 1e-7
    assert got[x == 1.0][0] == 0.0


def test_kernel_pow_keeps_pows_exact_cases():
    """y == 1 -> x and y == 0 -> 1 exactly (so nmda_mod = 1 rounds as
    XLA's pow), 0 ** y, negative bases, and within a few ulp of the JAX
    package's pow elsewhere."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 10, 5000).astype(np.float32)
    y = rng.uniform(0.2, 1.5, 5000).astype(np.float32)
    y[::5] = 1.0
    y[1::7] = 0.0
    x[2::11] = 0.0
    got = kernel_pow(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(jnp.power(jnp.asarray(x), jnp.asarray(y)))
    exact = (y == 1.0) | (y == 0.0) | (x == 0.0)
    np.testing.assert_array_equal(got[exact], want[exact])
    np.testing.assert_array_equal(got[y == 1.0], x[y == 1.0])
    assert (got[y == 0.0] == 1.0).all()
    np.testing.assert_allclose(got[~exact], want[~exact], rtol=1e-6)
    t = torch.tensor
    special = kernel_pow(t([0.0, 0.0, -2.0, -2.0, -2.0, 3.0]),
                         t([2.0, -1.0, 2.0, 3.0, 0.5, 1.0])).tolist()
    assert special[:4] == [0.0, float("inf"), 4.0, -8.0]
    assert np.isnan(special[4]) and special[5] == 3.0


# -- the twin against the TPU kernel ------------------------------------------


@pytest.mark.parametrize("name", KERNEL_CONFIGS)
def test_twin_matches_tpu_kernel(name):
    """8x8 chemical networks, 121 steps: the twin (use_kernel=True on the
    CPU) against `_fused_chunk` in interpret mode (use_pallas=True)."""
    j, t = both(lambda: chem_net(**CONFIGS[name]), True, True)
    j.run_lattices(STEPS)
    t.run_lattices(STEPS)
    assert j._last_run_fused is True
    assert t._last_run_fused == ("chemical", bool(
        CONFIGS[name].get("history")))
    assert_chem_networks_match(t, j)
    if CONFIGS[name].get("history"):
        np.testing.assert_allclose(
            np.stack(t.lattices[0].grid_history.history),
            np.stack([np.asarray(x)
                      for x in j.lattices[0].grid_history.history]),
            rtol=RTOL, atol=ATOL)
    if name.startswith("dopamine") and name != "dopamine-exponential_decay":
        assert (t.lattices[1].state["rec$nmda_modifier"] != 1.0).any()


def _jax_call(jnet, n_steps, uniforms):
    """One `_fused_chunk` call of the JAX chemical network's spec, built as
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
    tspecs = tuple(jpr._train_spec(s, sts[0].model)._replace(
        nt=sts[0].model.nt_kinetics
        if bool(np.asarray(s.state["nt$mask"]).any()) else "") for s in sts)
    cspecs, ops = [], []
    for c in plan["conns"]:
        pre_st = c["pre_is_st"]
        pre = st_index[c["pre"]] if pre_st else lat_index[c["pre"]]
        post = lat_index[c["post"]]
        pre_plastic = not pre_st and lspecs[pre].kind == "plastic"
        post_plastic = lspecs[post].kind == "plastic"
        cspecs.append(jpr.ConnSpec(pre_st, pre, post, False, 0, pre_plastic,
                                   post_plastic, pre_plastic or post_plastic))
        ops.append(c["op"])
    spec = jpr.NetSpec(lspecs, tspecs, tuple(cspecs), False,
                       electrical=bool(jnet.electrical_synapse),
                       chem=jpr._chem_spec(lats[0].model))
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
                            jnp.ones((len(jpr.RP_KEYS),), jnp.float32),
                            spk0=tuple(d.spk for d in lat_data))
    outs = jpr._fused_chunk(spec, n_steps, flat)
    return jpr._unflatten(spec, outs, lat_data, tr_data, cn_data)


def _port_inputs(t):
    plan = tsr.resolve_structured_plan(t)
    flags = tsr.nt_flags(t, plan)
    spec = nk.plain_network_spec(t, plan, False, flags[len(plan["lat_ids"]):])
    return (spec, *nk.member_inputs(spec, t, plan))


def _poisson_net():
    net = chem_net(family="dopaglugaba", rec="destexhe", nt="bounded",
                   dopamine=True, electrical=True, plastic=True,
                   train=snn.PoissonSpikeTrain(nt_kinetics="bounded"))
    st = net.spike_train_lattices[2]
    st.state = st.model.insert_neurotransmitter(
        st.model.init_from_firing_rate(64, hertz=400.0, dt=0.1), "AMPA")
    net.run_lattices(40)            # past firing, concentrations, modifiers
    return net


@pytest.mark.parametrize("n_steps", [16, 5])
def test_twin_matches_tpu_kernel_on_injected_uniforms(n_steps):
    """A Poisson-driven DopaGluGABA network with dopamine, electrical
    synapses and STDP: the TPU kernel (through `_flat_inputs` and
    `_fused_chunk`) and the twin read the same uniforms and the same
    previous spikes, so they agree call for call."""
    j = _poisson_net()
    t = network_from(j, "cpu")
    rng = np.random.default_rng(9)
    u = rng.random((n_steps, 8, 8)).astype(np.float32)
    jl, jt, jc, _, jspk, jtspk, _ = _jax_call(j, n_steps,
                                               [u.reshape(n_steps * 8, 8)])
    spec, lats, trains, conns = _port_inputs(t)
    assert spec.chem == ("dopaglugaba", "destexhe", "bounded")
    assert spec.trains[0].nt == "bounded" and spec.electrical
    tl, tt, tc, _ = nk.network_steps(spec, lats, trains, conns,
                                  [torch.from_numpy(u)],
                                  t._plasticity().params, t.internal_clock,
                                  n_steps)

    def back3(x):
        return np.moveaxis(np.asarray(x), 0, -1).reshape(-1, 3)

    for k, (a, b) in enumerate(zip(tl, jl)):
        for mine, theirs in (("v", b.v), ("w", b.w)):
            np.testing.assert_allclose(a[mine].numpy(), np.asarray(theirs),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{mine}{k}")
        for mine, theirs in (("nt$t", b.ntt), ("rec$r", b.recr),
                             ("rec$r2", b.recr2), ("rec$current", b.reccur)):
            np.testing.assert_allclose(a["chem"][mine].numpy(),
                                       back3(theirs), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{mine}{k}")
        for mine, theirs in (("rec$inh_modifier", b.inh),
                             ("rec$nmda_modifier", b.nmda)):
            np.testing.assert_allclose(a["chem"][mine].numpy(),
                                       np.asarray(theirs).reshape(-1),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{mine}{k}")
        np.testing.assert_array_equal(a["lft"].numpy(), np.asarray(b.lft))
        np.testing.assert_array_equal(a["spikes"].numpy(),
                                      np.asarray(jspk[k]) > 0.0)
        if spec.lattices[k].kind == "plastic":
            np.testing.assert_allclose(a["weights"].numpy(),
                                       np.asarray(b.wst), rtol=RTOL,
                                       atol=ATOL)
    assert (tl[1]["chem"]["rec$nmda_modifier"] != 1.0).any()
    np.testing.assert_array_equal(tt[0]["lft"].numpy(), np.asarray(jt[0].lft))
    np.testing.assert_array_equal(tt[0]["spikes"].numpy(),
                                  np.asarray(jtspk[0]) > 0.0)
    np.testing.assert_allclose(tt[0]["ntt"].numpy(), back3(jt[0].ntt),
                               rtol=RTOL, atol=ATOL)
    assert tt[0]["spikes"].any() or (tt[0]["lft"] >= 40).any()
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b.w).reshape(
            a.shape), rtol=RTOL, atol=ATOL)


# -- the wrapper ----------------------------------------------------------------


def _call_args(n_steps=5):
    t = network_from(_poisson_net(), "cpu")
    spec, lats, trains, conns = _port_inputs(t)
    u = [torch.rand((n_steps, *ts.shape), generator=torch.Generator()
                    .manual_seed(1)) for ts in spec.trains]
    return dict(spec=spec, lats=lats, trains=trains, conns=conns,
                uniforms=u, rule=t._plasticity().params, clock0=40,
                n_steps=n_steps)


def _flat(out):
    lat, tr, cn, extra = out
    assert extra is None
    xs = []
    for d in lat:
        for key, x in d.items():
            if key == "chem":
                xs += [y for _, y in sorted(x.items())]
            elif x is not None:
                xs.append(x)
    return xs + [x for d in tr for x in d.values() if x is not None] \
        + list(cn)


def test_wrapper_on_cpu_runs_the_twin_without_counting():
    args = _call_args()
    before = [{k: x.clone() for k, x in d["chem"].items()}
              for d in args["lats"]]
    counts = nk.LAUNCHES, nk.CHEM_LAUNCHES
    got = nk.network_steps(**args)
    want = nk.network_steps_reference(**args)
    assert (nk.LAUNCHES, nk.CHEM_LAUNCHES) == counts
    for g, w in zip(_flat(got), _flat(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for d, b in zip(args["lats"], before):        # inputs untouched
        for k, x in b.items():
            torch.testing.assert_close(d["chem"][k], x, rtol=0, atol=0)


def test_wrapper_rejects_what_the_chemical_arm_does_not_take():
    args = _call_args()
    spec = args["spec"]

    def call(**kw):
        return nk.network_steps(**{**args, **kw})

    def chem(k, **kw):
        lats = [dict(d, chem=dict(d["chem"])) for d in args["lats"]]
        lats[k]["chem"].update(kw)
        return dict(lats=lats)

    c0 = args["lats"][0]["chem"]
    bad = [chem(0, **{"nt$t": c0["nt$t"].double()}),
           chem(0, **{"rec$mask": c0["rec$mask"].float()}),
           chem(1, **{"rec$nmda_modifier": c0["rec$nmda_modifier"][:5]}),
           chem(0, **{"rec$g_ampa": c0["rec$r"]}),
           dict(lats=[dict(d, spikes=None) for d in args["lats"]]),
           dict(spec=spec._replace(chem=("ionotropic", "bounded",
                                         "unknown"))),
           dict(spec=spec._replace(lattices=(spec.lattices[0]._replace(
               model="lif"),) + spec.lattices[1:])),
           dict(spec=spec._replace(chem=(), electrical=True)),
           dict(spec=spec._replace(conns=(spec.conns[0]._replace(
               op=("resample", 8, 8, 8, 8, 1, 1, ((0, 0),))),)
               + spec.conns[1:]))]
    for kw in bad:
        with pytest.raises((ValueError, KeyError)):
            call(**kw)


# -- on a CUDA card only ------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [16, 7])
def test_cuda_chemical_arm_matches_twin(n_steps):
    """Built with -fmad=false, the chemical arm rounds as the twin does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    args = _call_args(n_steps)

    def cuda(x):
        if isinstance(x, torch.Tensor):
            return x.cuda()
        if isinstance(x, dict):
            return {k: cuda(v) for k, v in x.items()}
        return x

    args.update(lats=[cuda(d) for d in args["lats"]],
                trains=[cuda(d) for d in args["trains"]],
                conns=[cuda(d) for d in args["conns"]],
                uniforms=[u.cuda() for u in args["uniforms"]])
    before = nk.CHEM_LAUNCHES
    got = nk.network_steps(**args)
    torch.cuda.synchronize()
    assert nk.CHEM_LAUNCHES == before + 1
    want = nk.network_steps_reference(**args)
    for g, w in zip(_flat(got), _flat(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [16, 7, 37])
def test_cuda_persistent_and_per_step_designs_match_twin(n_steps):
    """The chemical arm through the persistent kernel with every member
    resident in shared memory (the route `uses_persistent` gives it) and
    with every member streamed (its launcher at a budget of 0), and
    through the per-step design, each bit for bit; 37 steps take three
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from spiking_neural_networks_tpu_torch import _build
    args = _call_args(n_steps)

    def cuda(x):
        if isinstance(x, torch.Tensor):
            return x.cuda()
        if isinstance(x, dict):
            return {k: cuda(v) for k, v in x.items()}
        return x

    args.update(lats=[cuda(d) for d in args["lats"]],
                trains=[cuda(d) for d in args["trains"]],
                conns=[cuda(d) for d in args["conns"]],
                uniforms=[u.cuda() for u in args["uniforms"]])
    assert nk.uses_persistent(args["spec"])
    want = nk.network_steps_reference(**args)
    outs = []
    for per_step in (False, True):
        before = (nk.CHEM_LAUNCHES, nk.PERSISTENT_LAUNCHES)
        outs.append(nk.network_steps(**args, per_step=per_step))
        torch.cuda.synchronize()
        assert (nk.CHEM_LAUNCHES, nk.PERSISTENT_LAUNCHES) == (
            before[0] + 1, before[1] + (not per_step))
    rc, streamed = nk._launch_persistent(
        _build.load(), *(args[k] for k in (
            "spec", "lats", "trains", "conns", "uniforms", "rule", "clock0",
            "n_steps")), torch.cuda.current_stream().cuda_stream, None, 0)
    torch.cuda.synchronize()
    assert rc == 0
    for got in outs + [streamed]:
        assert len(_flat(got)) == len(_flat(want))
        for g, w in zip(_flat(got), _flat(want)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)

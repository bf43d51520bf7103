"""The closed loop's one-step kernel entry
(`reward_kernels.env_step_launcher`, reward and clock in device memory)
and its plain twin (`env_step_launcher_reference`): the twin against the by-value twin of the
plasticity kernels given the same rewards (bit-equal), against the TPU
kernel's env form (``pallas_reward._env_advance``, interpret mode), the
wrapper's checks and gate; on a CUDA card only, the CUDA kernel (its
launches sharing an `reward_kernels.EnvChain`, flushed after the last
step) against the twin.

Tolerance against the TPU kernel: rtol 1e-6, atol 1e-5 on v, w, weights,
traces and dopamine, firing times and spikes equal (as
``tests/test_torch_reward_kernel.py``: XLA's CPU backend rounds an exp of
the rule constants differently in the last bit).
"""

import itertools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.ops import pallas_reward as jpr
from spiking_neural_networks_tpu_torch.ops import reward_kernels as rk
from torch_lattices import MODELS, bits_equal, jax_lattice, port_of

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-5
K = rk.STEPS_PER_LAUNCH
# (kind, with_reward) of the closed loop: run_with_reward and run
ENV_KINDS = (("mod", True), ("plain", True), ("plain", False),
             ("plastic", False))


def step_inputs(kind, model, rows=9, cols=11, seed=4, device="cpu"):
    """Buffers of one closed loop from a JAX lattice's numbers: two plane
    sets, spikes, weights, traces, dopamine 0.3, clock 7."""
    j = jax_lattice(model, "plastic" if kind == "plastic" else kind, rows,
                    cols, seed)
    t = port_of(j, model, use_kernel=True)
    st, g, shape = t.state, t.graph, (rows, cols)
    to = lambda x: None if x is None else x.to(device)
    src = tuple(to(x) for x in (
        st["v"].reshape(shape),
        st["w"].reshape(shape) if "w" in st else torch.zeros(shape),
        st["last_firing_time"].reshape(shape),
        st["refractory_count"].reshape(shape)
        if model in rk.REFRACTORY_MODELS else None))
    return dict(
        src=src, dst=tuple(None if x is None else torch.zeros_like(x)
                           for x in src),
        spikes=to(st["is_spiking"].reshape(shape)),
        weights=to(g.weights.clone()), mask=to(g.mask), in_deg=to(g.in_deg),
        params={k: to(st[k].reshape(shape))
                for k in rk.MODEL_PARAM_KEYS[model]},
        traces=tuple(to(t.trace[k].clone()) for k in ("c", "dw", "counter"))
        if kind == "mod" else None,
        dopamine=torch.tensor(0.3, device=device),
        rule=t.plasticity.params if kind == "plastic"
        else t.reward_modulator.params,
        clock=torch.tensor([7], dtype=torch.int32, device=device),
        offsets=g.offsets)


def launchers(make, spec, inp, links=None):
    """The launches of ``make`` (`env_step_launcher` or its twin) from
    each of the two plane sets into the other (the kernel's sharing the
    `EnvChain` ``links``)."""
    planes = [inp["src"], inp["dst"]]
    kw = {} if links is None else dict(chain=links)
    return [make(spec, planes[p], planes[1 - p], inp["spikes"],
                 inp["weights"], inp["mask"], inp["in_deg"], inp["params"],
                 inp["traces"], inp["dopamine"], inp["rule"], inp["clock"],
                 **kw)
            for p in (0, 1)]


def chain(make, spec, inp, n=K):
    """``n`` steps of ``make``'s launches between two plane sets, each
    reward computed on the device from the state the step receives, and
    for the kernel a flush of its `EnvChain`.  Returns the final planes
    and the rewards."""
    planes = [inp["src"], inp["dst"]]
    links = rk.EnvChain(inp["dopamine"], inp["clock"],
                        tuple(inp["src"][0].shape)) \
        if make is rk.env_step_launcher else None
    launch = launchers(make, spec, inp, links)
    rewards = []
    for k in range(n):
        p = k % 2
        v = planes[p][0]
        reward = (0.05 - 0.001 * v.mean()
                  + 0.1 * inp["spikes"].to(torch.float32).mean()).reshape(())
        rewards.append(reward.clone())
        launch[p](reward)
    if links is not None:
        links.flush()
    return planes[n % 2], torch.stack(rewards)


@pytest.mark.parametrize("kind,with_reward,model", [
    (k, r, m) for (k, r), m in itertools.product(ENV_KINDS, MODELS)])
def test_env_twin_equals_the_by_value_twin(kind, with_reward, model):
    """16 chained steps of the env twin, rewards from the device, against
    one call of `lattice_plasticity_steps_reference` given those rewards by
    value: bit-equal."""
    inp = step_inputs(kind, model)
    clone = lambda x: x.clone() if isinstance(x, torch.Tensor) else \
        tuple(map(clone, x)) if isinstance(x, tuple) else x
    start = {k: clone(v) for k, v in inp.items()}
    spec = rk.LatSpec(kind, model, inp["offsets"], with_reward=with_reward)
    planes, rewards = chain(rk.env_step_launcher_reference, spec, inp)
    want = rk.lattice_plasticity_steps_reference(
        spec, *start["src"], start["weights"], start["mask"],
        start["in_deg"], start["params"], start["traces"],
        start["dopamine"], start["rule"],
        rewards.numpy() if with_reward else None, 7, K)
    got = list(planes) + [inp["spikes"], inp["weights"]]
    for g, w in zip(got, want[:6]):
        if g is not None:
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    if kind == "mod":
        for g, w in zip(inp["traces"], want[6]):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    torch.testing.assert_close(inp["dopamine"], want[7], rtol=0, atol=0)
    assert int(inp["clock"]) == 7 + K
    assert (planes[2] >= 7).any()                     # fired in the run
    if kind != "plain":
        assert not torch.equal(inp["weights"], start["weights"])


def test_env_twin_matches_the_tpu_kernel_env_form():
    """20 steps of the env twin with torch callbacks against
    ``pallas_reward._env_advance`` with the same callbacks in jnp, in
    interpret mode (launches of 4 steps), on a 12 x 10 ALIF R-STDP
    lattice."""
    model, shape = "alif", (12, 10)
    j = jax_lattice(model, "mod", *shape)
    t = port_of(j, model, use_kernel=True)
    n = 20

    def j_reward(env, s):
        return jnp.float32(0.05) - jnp.float32(0.1) * env["rate"]

    def j_update(env, s):
        return {"rate": jnp.float32(0.8) * env["rate"] + jnp.float32(0.2)
                * s["is_spiking"].astype(jnp.float32).mean()}

    def j_encode(env, s):
        return {**s, "v": s["v"] + jnp.float32(0.5)}

    spec = jpr.NetSpec((jpr.LatSpec("mod", j.graph.offsets, model, shape),),
                       (), (), True)
    leaves, treedef = jax.tree_util.tree_flatten({"rate": jnp.float32(0.1)})
    es = jpr.EnvSpec(j_reward, j_update, j_encode, treedef, len(leaves))
    rp = {k: jnp.float32(v) for k, v in j.reward_modulator.params.items()}
    lat_data = (jpr._lat_data(spec, 0, j.state, j.graph, j.trace),)
    spk0 = (j.state["is_spiking"].astype(jnp.float32).reshape(shape),)
    lat_data, spk, dop, env_vec, jrew = jpr._env_advance(
        spec, es, n, lat_data, spk0, jnp.float32(j.dopamine),
        jnp.int32(j.internal_clock), jnp.stack(leaves),
        jnp.stack([rp.get(k, jnp.float32(0.0)) for k in jpr.PP_KEYS]),
        jnp.stack([rp[k] for k in jpr.RP_KEYS]), chunk=4)
    d = lat_data[0]

    # the port: the twin, one step at a time, with the same callbacks
    st, g = t.state, t.graph
    src = (st["v"].reshape(shape).clone(), st["w"].reshape(shape).clone(),
           st["last_firing_time"].reshape(shape).clone(),
           st["refractory_count"].reshape(shape).clone())
    planes = [src, tuple(torch.zeros_like(x) for x in src)]
    spikes = st["is_spiking"].reshape(shape).clone()
    weights = g.weights.clone()
    traces = tuple(t.trace[k].clone() for k in ("c", "dw", "counter"))
    dopamine = torch.tensor(t.dopamine)
    clock = torch.tensor([t.internal_clock], dtype=torch.int32)
    params = {k: st[k].reshape(shape) for k in rk.MODEL_PARAM_KEYS[model]}
    rule = t.reward_modulator.params
    rate = torch.tensor(0.1)
    trew = []
    view = lambda p: {"v": planes[p][0], "w": planes[p][1],
                      "last_firing_time": planes[p][2],
                      "refractory_count": planes[p][3],
                      "is_spiking": spikes}
    tspec = rk.LatSpec("mod", model, g.offsets, with_reward=True)
    launch = [rk.env_step_launcher_reference(
        tspec, planes[p], planes[1 - p], spikes, weights, g.mask, g.in_deg,
        params, traces, dopamine, rule, clock) for p in (0, 1)]
    for k in range(n):
        p = k % 2
        reward = (0.05 - 0.1 * rate).reshape(())
        trew.append(float(reward))
        launch[p](reward)
        s = view(1 - p)
        rate = 0.8 * rate + 0.2 * s["is_spiking"].to(torch.float32).mean()
        planes[1 - p][0].copy_(s["v"] + 0.5)
    v, w, lft, refr = planes[n % 2]
    np.testing.assert_allclose(np.asarray(trew), np.asarray(jrew),
                               rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(v.numpy(), np.asarray(d.v), RTOL, ATOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(d.w), RTOL, ATOL)
    np.testing.assert_array_equal(lft.numpy(), np.asarray(d.lft))
    np.testing.assert_array_equal(refr.numpy(), np.asarray(d.refr))
    np.testing.assert_array_equal(spikes.numpy(), np.asarray(spk[0]) > 0)
    np.testing.assert_allclose(weights.numpy(), np.asarray(d.wst), RTOL,
                               ATOL)
    for a, b in zip(traces, d.traces):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), RTOL, ATOL)
    np.testing.assert_allclose(float(dopamine), float(dop), rtol=1e-5)
    np.testing.assert_allclose(float(rate), float(env_vec[0]), rtol=1e-5,
                               atol=1e-6)
    assert int(clock) == j.internal_clock + n
    assert (lft >= j.internal_clock).any()


def test_launcher_on_cpu_runs_the_twin_without_counting():
    inp = step_inputs("mod", "izhikevich")
    spec = rk.LatSpec("mod", "izhikevich", inp["offsets"], with_reward=True)
    before = rk.ENV_LAUNCHES
    launch = rk.env_step_launcher(
        spec, inp["src"], inp["dst"], inp["spikes"], inp["weights"],
        inp["mask"], inp["in_deg"], inp["params"], inp["traces"],
        inp["dopamine"], inp["rule"], inp["clock"])
    launch(torch.tensor(0.1))
    launch(torch.tensor(0.1))
    assert rk.ENV_LAUNCHES == before
    assert int(inp["clock"]) == 9


def test_env_entry_rejects_what_the_kernel_does_not_take():
    inp = step_inputs("mod", "alif")
    spec = rk.LatSpec("mod", "alif", inp["offsets"], with_reward=True)
    args = dict(spec=spec, src=inp["src"], dst=inp["dst"],
                spikes=inp["spikes"], weights=inp["weights"],
                mask=inp["mask"], in_deg=inp["in_deg"],
                params=inp["params"], traces=inp["traces"],
                dopamine=inp["dopamine"], rule=inp["rule"],
                clock=inp["clock"])

    def call(reward=torch.tensor(0.1), **kw):
        rk.env_step_launcher(**{**args, **kw})(reward)

    d = inp["dst"]
    call()
    bad = [dict(reward=torch.tensor([0.1])), dict(reward=torch.tensor(1)),
           dict(reward=torch.tensor(0.1, dtype=torch.float64)),
           dict(clock=torch.tensor(7, dtype=torch.int32)),
           dict(clock=inp["clock"].long()),
           dict(dst=(inp["src"][0],) + d[1:]),
           dict(dst=(d[0], d[1], d[2], None)),
           dict(spikes=inp["spikes"].to(torch.uint8)),
           dict(dopamine=torch.tensor([0.3])), dict(traces=None),
           dict(spec=spec._replace(kind="plastic"))]
    for kw in bad:
        with pytest.raises(ValueError):
            call(**kw)


def test_supports_plain_lattice_mirrors_jax():
    """`supports_plain_lattice` accepts what the JAX gate accepts, without
    its 128-column cap."""
    for name, (jcls, tcls) in MODELS.items():
        j = snn.Lattice(jcls())
        t = snt.Lattice(tcls(), device="cpu")
        for lat in (j, t):
            lat.populate(6, 5)
        assert not rk.supports_plain_lattice(t)
        assert not jpr.supports_plain_lattice(j)
        for lat in (j, t):
            lat.connect_stencil(radius=1.5)
            lat.do_plasticity = True
        assert rk.supports_plain_lattice(t) and jpr.supports_plain_lattice(j)
        for lat in (j, t):
            lat.chemical_synapse = True
        assert not rk.supports_plain_lattice(t)
        assert not jpr.supports_plain_lattice(j)
    wide = snt.Lattice(snt.Izhikevich(), device="cpu")
    wide.populate(4, 192)
    wide.connect_stencil(radius=2.0)
    assert rk.supports_plain_lattice(wide)
    hh = snt.Lattice(snt.HodgkinHuxley(), device="cpu")
    hh.populate(4, 4)
    hh.connect_stencil(radius=1.0)
    assert not rk.supports_plain_lattice(hh)


# -- on a CUDA card only ------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kind,with_reward,model", [
    (k, r, m) for (k, r), m in itertools.product(ENV_KINDS, MODELS)])
def test_cuda_env_kernel_matches_twin(kind, with_reward, model):
    """16 chained steps of the CUDA env entry against its twin on the
    card, rewards computed on the device: bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    outs = []
    for make in (rk.env_step_launcher, rk.env_step_launcher_reference):
        inp = step_inputs(kind, model, 64, 48, device="cuda")
        spec = rk.LatSpec(kind, model, inp["offsets"],
                          with_reward=with_reward)
        before = rk.ENV_LAUNCHES
        planes, rewards = chain(make, spec, inp)
        torch.cuda.synchronize()
        if make is rk.env_step_launcher:
            assert rk.ENV_LAUNCHES == before + K + (kind != "plain")
        outs.append([x for x in list(planes) + [
            inp["spikes"], inp["weights"], inp["dopamine"], inp["clock"],
            rewards] + list(inp["traces"] or ()) if x is not None])
    for g, w in zip(*outs):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,with_reward,model", [
    (k, r, m) for (k, r), m in itertools.product(ENV_KINDS, MODELS)])
def test_cuda_env_kernel_schedule_cases(kind, with_reward, model):
    """The env entry's fused launches (step k-1's edge pass in step k's
    launch, then a flush) on a 33 x 70 grid (a width that is not a
    multiple of the 32-column tile, and a partial last tile row), a tenth
    of the weights -0.0 and counters of 2: 16 chained steps bit-equal to
    the twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    outs = []
    for make in (rk.env_step_launcher, rk.env_step_launcher_reference):
        inp = step_inputs(kind, model, 33, 70, device="cuda")
        rng = np.random.default_rng(8)
        some = torch.from_numpy(rng.random(tuple(inp["weights"].shape))
                                < 0.1).cuda()
        inp["weights"][some] = -0.0
        if inp["traces"] is not None:
            inp["traces"][2][some] = 2
        spec = rk.LatSpec(kind, model, inp["offsets"],
                          with_reward=with_reward)
        planes, rewards = chain(make, spec, inp)
        torch.cuda.synchronize()
        outs.append([x for x in list(planes) + [
            inp["spikes"], inp["weights"], inp["dopamine"], inp["clock"],
            rewards] + list(inp["traces"] or ()) if x is not None])
    for g, w in zip(*outs):
        assert bits_equal(g, w)

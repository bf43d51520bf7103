"""The port's closed loops (`Environment`, `UnsupervisedEnvironment`,
`interactable.JitEnvironment`) against the JAX package's, on 8 x 8
lattices.

The same callbacks are written twice, in jnp and in torch, with the same
arithmetic; agents and environments are carried into the port with
`convert`.  Routes: the port's plain route (``use_kernel=False``) against
the JAX XLA path (``use_pallas=False``); the port's kernel tiers on the
CPU (``use_kernel=True``: the kernels' plain twin each step) against the
JAX env-fused path in interpret mode (``use_pallas=True``), over 20 steps,
which crosses the port's K = 16 boundary.  Tolerances are those of
``tests/test_interactable.py``: rewards rtol 1e-6, atol 1e-6; v rtol 1e-5,
atol 1e-4; firing times and spikes equal; weights and traces rtol 1e-5,
atol 1e-5; dopamine 1e-4 relative; env rtol 1e-5, atol 1e-6.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.interactable import (
    Environment as JEnvironment, JitEnvironment as JJit,
    UnsupervisedEnvironment as JUnsupervised)
from spiking_neural_networks_tpu_torch.convert import (
    env_from, lattice_from, reward_lattice_from)
from spiking_neural_networks_tpu_torch.core import history as th
from spiking_neural_networks_tpu_torch.interactable import (
    Environment, JitEnvironment, UnsupervisedEnvironment)
from spiking_neural_networks_tpu_torch.ops import reward_kernels as rk
from torch_lattices import MODELS, RSTDP

torch.set_num_threads(1)

TARGET = 0.10
STEPS = 20


def jax_agent(model="izhikevich", modulation=True, plastic=None, rows=8,
              cols=8, use_pallas=False):
    """An 8 x 8 JAX agent of ``model``: a `RewardModulatedLattice`, or
    with ``plastic`` set a plain `Lattice` (STDP when True).  Radius 1.5,
    keep 0.9, v0 across the threshold with a cue of 6 neurons at 40 mV,
    every second neuron fired at step 3, clock 4 (so a firing time > 3 is
    one of the run)."""
    jcls = MODELS[model][0]
    lat = snn.RewardModulatedLattice(jcls()) if plastic is None \
        else snn.Lattice(jcls())
    lat.populate(rows, cols, gap_conductance=10.0)
    lat.connect_stencil(radius=1.5, keep_prob=0.9, seed=2)
    n = rows * cols
    lo, hi = (-65.0, 30.0) if model == "izhikevich" else (-70.0, -45.0)
    v0 = np.random.default_rng(0).uniform(lo, hi, n).astype(np.float32)
    v0[:6] = 40.0
    lft = np.full(n, -1, np.int32)
    lft[::2] = 3
    lat.apply(lambda s: {**s, "v": jnp.asarray(v0),
                         "last_firing_time": jnp.asarray(lft)})
    lat.internal_clock = 4
    if plastic is None:
        lat.do_modulation = modulation
        lat.reward_modulator = snn.RewardModulatedSTDP(**RSTDP)
    else:
        lat.do_plasticity = plastic
        lat.plasticity = snn.STDP(a_plus=0.02, a_minus=0.02)
    lat.use_pallas = use_pallas
    return lat


def port_agent(j, model="izhikevich", use_kernel=None):
    tcls = MODELS[model][1]
    t = reward_lattice_from(j, tcls(), "cpu") \
        if isinstance(j, snn.RewardModulatedLattice) \
        else lattice_from(j, tcls(), "cpu")
    t.use_kernel = use_kernel
    return t


# -- the callbacks, in jnp (shape-polymorphic, for the env-fused path) and
#    in torch on the flat state ---------------------------------------------


def j_reward(e, s):
    return jnp.float32(TARGET) - e["rate"]


def j_update(e, s):
    spiking = s["is_spiking"].astype(jnp.float32).mean()
    return {"rate": jnp.float32(0.9) * e["rate"]
            + jnp.float32(0.1) * spiking}


def j_encoder(e, s):
    v = s["v"]
    if v.ndim == 1:
        fi = jax.lax.iota(jnp.int32, v.shape[0])
    else:
        r = jax.lax.broadcasted_iota(jnp.int32, v.shape, 0)
        c = jax.lax.broadcasted_iota(jnp.int32, v.shape, 1)
        fi = r * v.shape[1] + c
    return {**s, "v": jnp.where(fi < 6, jnp.float32(40.0), v)}


def t_reward(e, s):
    return TARGET - e["rate"]


def t_update(e, s):
    spiking = s["is_spiking"].to(torch.float32).mean()
    return {"rate": 0.9 * e["rate"] + 0.1 * spiking}


def t_encoder(e, s):
    v = s["v"]
    cue = torch.arange(v.shape[0], device=v.device) < 6
    return {**s, "v": torch.where(cue, 40.0, v)}


def jax_env(j):
    return JJit(j, {"rate": jnp.float32(0.0)}, j_encoder, j_reward,
                j_update)


def port_env(t):
    return JitEnvironment(t, env_from({"rate": np.float32(0.0)}, "cpu"),
                          t_encoder, t_reward, t_update)


def assert_agents_match(t, j, te=None, je=None):
    np.testing.assert_allclose(t.state["v"].numpy(), np.asarray(j.state["v"]),
                               rtol=1e-5, atol=1e-4, err_msg="v")
    for k in ("last_firing_time", "is_spiking"):
        np.testing.assert_array_equal(t.state[k].numpy(),
                                      np.asarray(j.state[k]), err_msg=k)
    if "refractory_count" in j.state:
        np.testing.assert_allclose(t.state["refractory_count"].numpy(),
                                   np.asarray(j.state["refractory_count"]),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.graph.weights.numpy(),
                               np.asarray(j.graph.weights), rtol=1e-5,
                               atol=1e-5, err_msg="weights")
    if isinstance(j, snn.RewardModulatedLattice):
        for k in ("c", "dw"):
            np.testing.assert_allclose(t.trace[k].numpy(),
                                       np.asarray(j.trace[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(t.trace["counter"].numpy(),
                                      np.asarray(j.trace["counter"]))
        assert abs(t.dopamine - j.dopamine) <= 1e-4 * max(1.0,
                                                          abs(j.dopamine))
    assert t.internal_clock == j.internal_clock
    if te is not None:
        np.testing.assert_allclose(float(te.state["rate"]),
                                   float(je.state["rate"]), rtol=1e-5,
                                   atol=1e-6)


# -- the host loop ------------------------------------------------------------


class _JaxHostState:
    def __init__(self):
        self.rate = np.float32(0.0)

    def update_state(self, agent):
        spiking = np.float32(np.asarray(agent.state["is_spiking"],
                                        np.float32).mean())
        self.rate = np.float32(0.9) * self.rate + np.float32(0.1) * spiking


class _PortHostState:
    def __init__(self):
        self.rate = np.float32(0.0)

    def update_state(self, agent):
        spiking = np.float32(agent.state["is_spiking"].to(
            torch.float32).mean().item())
        self.rate = np.float32(0.9) * self.rate + np.float32(0.1) * spiking


def _jax_host_encoder(state, agent):
    agent.apply(lambda s: {**s, "v": s["v"].at[:6].set(40.0)})


def _port_host_encoder(state, agent):
    def cue(s):
        v = s["v"].clone()
        v[:6] = 40.0
        return {**s, "v": v}
    agent.apply(cue)


def _host_reward(state, agent):
    return float(np.float32(TARGET) - state.rate)


def test_host_environment_matches_jax():
    """`Environment.run_with_reward` for 40 steps: host callbacks over
    `update_and_apply_reward`, both packages."""
    j = jax_agent()
    t = port_agent(j)
    je = JEnvironment(j, _JaxHostState(), _jax_host_encoder, _host_reward)
    te = Environment(t, _PortHostState(), _port_host_encoder, _host_reward)
    je.run_with_reward(40)
    te.run_with_reward(40)
    assert_agents_match(t, j)
    np.testing.assert_allclose(te.state.rate, je.state.rate, rtol=1e-5,
                               atol=1e-6)
    assert (t.state["last_firing_time"] > 3).any()


def test_host_unsupervised_environment_matches_jax():
    j = jax_agent(plastic=True)
    t = port_agent(j)

    class Still:
        def update_state(self, agent):
            pass

    JUnsupervised(j, Still(), _jax_host_encoder).run(30)
    UnsupervisedEnvironment(t, Still(), _port_host_encoder).run(30)
    assert_agents_match(t, j)
    with pytest.raises(ValueError):
        UnsupervisedEnvironment(t, Still(), _port_host_encoder) \
            .run_with_reward(1)


# -- JitEnvironment.run_with_reward ------------------------------------------


def test_plain_route_matches_jax_xla():
    """``use_kernel=False`` against the XLA scan, 40 steps."""
    j = jax_agent()
    t = port_agent(j, use_kernel=False)
    je, te = jax_env(j), port_env(t)
    rj = je.run_with_reward(40)
    rt = te.run_with_reward(40)
    assert not te.last_build_fused and not te.last_build_env_fused
    assert rt.dtype == np.float32 and rt.shape == (40,)
    np.testing.assert_allclose(rt, rj, rtol=1e-6, atol=1e-6)
    assert_agents_match(t, j, te, je)
    assert not np.array_equal(t.graph.weights.numpy(),
                              np.asarray(jax_agent().graph.weights))


@pytest.mark.parametrize("model,modulation", [
    ("izhikevich", True), ("izhikevich", False), ("alif", True),
    ("lif", True)])
def test_kernel_tiers_match_jax_env_fused(model, modulation):
    """The port's kernel tier on the CPU (the twin each step; no graph,
    so tier (b)) against the JAX env-fused kernel in interpret mode, 20
    steps."""
    j = jax_agent(model, modulation, use_pallas=True)
    t = port_agent(j, model, use_kernel=True)
    je, te = jax_env(j), port_env(t)
    rj = je.run_with_reward(STEPS)
    rt = te.run_with_reward(STEPS)
    assert je.last_build_env_fused
    assert te.last_build_fused and not te.last_build_env_fused
    assert rt.dtype == np.float32 and rt.shape == (STEPS,)
    np.testing.assert_allclose(rt, rj, rtol=1e-6, atol=1e-6)
    assert_agents_match(t, j, te, je)
    assert (t.state["last_firing_time"] > 3).any()


def test_kernel_tiers_equal_plain_route_and_two_calls_equal_one():
    """The kernel tier in calls of 7 + 13 steps (a clock not at 0 at the
    second call) and in one call of 20; the plain route within the
    tolerances."""
    base = jax_agent()
    one, two, plain = (port_agent(base, use_kernel=u)
                       for u in (True, True, False))
    e1, e2, ep = port_env(one), port_env(two), port_env(plain)
    r1 = e1.run_with_reward(STEPS)
    r2 = np.concatenate([e2.run_with_reward(7), e2.run_with_reward(13)])
    rp = ep.run_with_reward(STEPS)
    np.testing.assert_array_equal(r1, r2)
    for k in one.state:
        torch.testing.assert_close(one.state[k], two.state[k], rtol=0,
                                   atol=0)
    for k in one.trace:
        torch.testing.assert_close(one.trace[k], two.trace[k], rtol=0,
                                   atol=0)
    assert one.dopamine == two.dopamine
    assert one.internal_clock == two.internal_clock == 4 + STEPS
    assert float(e1.state["rate"]) == float(e2.state["rate"])
    np.testing.assert_allclose(r1, rp, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(one.state["v"].numpy(),
                               plain.state["v"].numpy(), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(one.graph.weights.numpy(),
                               plain.graph.weights.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_history_takes_tier_b_with_the_same_steps():
    """A grid history takes tier (b): the same steps as a call without
    one, bit for bit, and the history's last row is the final v."""
    runs = []
    for hist in (False, True):
        t = port_agent(jax_agent(), use_kernel=True)
        t.update_grid_history = hist
        env = port_env(t)
        runs.append((env.run_with_reward(STEPS), t, env))
    (ra, a, ea), (rb, b, eb) = runs
    # on the CPU no graph replays: both calls are tier (b)
    assert ea.last_build_fused and eb.last_build_fused
    assert not ea.last_build_env_fused and not eb.last_build_env_fused
    np.testing.assert_array_equal(ra, rb)
    for k in a.state:
        torch.testing.assert_close(a.state[k], b.state[k], rtol=0, atol=0)
    np.testing.assert_array_equal(b.grid_history.history[-1].reshape(-1),
                                  b.state["v"].numpy())


def test_random_callback_draws_alike_on_both_tiers():
    """An encoder that draws a random cue from the default generator: the
    probe of a call without a history leaves the generator as it found
    it, so that call and one with a grid history (no probe) draw the same
    numbers."""
    def cue(e, s):
        u = torch.rand(s["v"].shape[0], device=s["v"].device)
        return {**s, "v": torch.where(u < 0.1, 40.0, s["v"])}

    runs = []
    for hist in (False, True):
        torch.manual_seed(3)
        t = port_agent(jax_agent(), use_kernel=True)
        t.update_grid_history = hist
        env = JitEnvironment(t, env_from({"rate": np.float32(0)}, "cpu"),
                             cue, t_reward, t_update)
        runs.append((env.run_with_reward(STEPS), t))
    (ra, a), (rb, b) = runs
    np.testing.assert_array_equal(ra, rb)
    torch.testing.assert_close(a.state["v"], b.state["v"], rtol=0, atol=0)


def test_repeat_and_clock():
    """As the JAX test: two calls of 30 steps advance the clock by 60
    (from 4)."""
    for use in (True, False):
        t = port_agent(jax_agent(), use_kernel=use)
        env = JitEnvironment(t, env_from({"rate": np.float32(0)}, "cpu"),
                             lambda e, s: s,
                             lambda e, s: torch.tensor(0.5),
                             lambda e, s: e)
        env.run_with_reward(30)
        env.run_with_reward(30)
        assert t.internal_clock == 64
        assert env.last_build_fused is use


# -- JitEnvironment.run ------------------------------------------------------


@pytest.mark.parametrize("plastic", [False, True])
@pytest.mark.parametrize("use", [False, True])
def test_unsupervised_run_matches_jax(plastic, use):
    """`run` on a plain and an STDP `Lattice`: the plain route against the
    XLA scan, the kernel tiers against the env-fused kernel."""
    j = jax_agent(plastic=plastic, use_pallas=use)
    t = port_agent(j, use_kernel=use)
    je = JJit(j, {"rate": jnp.float32(0.0)}, j_encoder, None, j_update)
    te = JitEnvironment(t, env_from({"rate": np.float32(0.0)}, "cpu"),
                        t_encoder, None, t_update)
    je.run(STEPS)
    te.run(STEPS)
    assert je.last_build_env_fused is use
    assert not te.last_build_env_fused and te.last_build_fused is use
    assert_agents_match(t, j, te, je)
    if plastic:
        assert not np.array_equal(t.graph.weights.numpy(),
                                  np.asarray(jax_agent(plastic=True)
                                             .graph.weights))


# -- histories -------------------------------------------------------------


@pytest.mark.parametrize("supervised", [True, False])
@pytest.mark.parametrize("use", [False, True])
def test_grid_history_matches_jax(supervised, use):
    """A grid history: tier (b) (the kernel per step, read out per step)
    and the plain route against the JAX package, chunked at 7 steps."""
    j = jax_agent(plastic=None if supervised else True, use_pallas=use)
    t = port_agent(j, use_kernel=use)
    for lat in (j, t):
        lat.update_grid_history = True
        lat.history_chunk = 7
    if supervised:
        je, te = jax_env(j), port_env(t)
        np.testing.assert_allclose(te.run_with_reward(STEPS),
                                   je.run_with_reward(STEPS), rtol=1e-6,
                                   atol=1e-6)
    else:
        je = JJit(j, {"rate": jnp.float32(0.0)}, j_encoder, None, j_update)
        te = JitEnvironment(t, env_from({"rate": np.float32(0.0)}, "cpu"),
                            t_encoder, None, t_update)
        je.run(STEPS)
        te.run(STEPS)
    assert te.last_build_fused is use and not te.last_build_env_fused
    ht, hj = np.stack(t.grid_history.history), \
        np.stack(j.grid_history.history)
    assert ht.shape == hj.shape == (STEPS, 8, 8)
    np.testing.assert_allclose(ht, hj, rtol=1e-5, atol=1e-4)
    assert_agents_match(t, j, te, je)


def test_eeg_history_on_the_kernel_tier():
    j = jax_agent(use_pallas=True)
    t = port_agent(j, use_kernel=True)
    from spiking_neural_networks_tpu.core.history import EEGHistory
    j.grid_history, t.grid_history = EEGHistory(), th.EEGHistory()
    for lat in (j, t):
        lat.update_grid_history = True
    jax_env(j).run_with_reward(12)
    port_env(t).run_with_reward(12)
    assert len(t.grid_history.history) == 12
    np.testing.assert_allclose(np.asarray(t.grid_history.history),
                               np.asarray(j.grid_history.history),
                               rtol=1e-5, atol=1e-6)


def test_graph_history_raises():
    t = port_agent(jax_agent(), use_kernel=True)
    t.update_graph_history = True
    with pytest.raises(ValueError):
        port_env(t).run_with_reward(3)


# -- the callbacks' contract ---------------------------------------------------


@pytest.mark.parametrize("use", [True, False])
def test_lif_callback_reading_w_raises(use):
    """A LIF agent has no ``w``: a callback that reads it raises KeyError
    on every tier, as in the JAX package, and no tier claims the run."""
    t = port_agent(jax_agent("lif"), "lif", use_kernel=use)
    env = JitEnvironment(t, env_from({"rate": np.float32(0)}, "cpu"),
                         t_encoder, lambda e, s: s["w"].mean(), t_update)
    with pytest.raises(KeyError):
        env.run_with_reward(3)
    assert not env.last_build_env_fused and not env.last_build_fused
    ok = port_env(port_agent(jax_agent("lif"), "lif", use_kernel=use))
    ok.run_with_reward(3)
    assert ok.last_build_fused is use and not ok.last_build_env_fused


def test_encoder_writes_reach_the_kernel_tier():
    """An encoder that writes a parameter plane and the firing times: the
    kernel tier carries both into the next step, as the plain route does."""
    def encoder(e, s):
        return {**s, "gap_conductance": s["gap_conductance"] * 1.01,
                "last_firing_time": torch.where(
                    s["v"] > 20.0, 1, s["last_firing_time"])}

    runs = []
    for use in (True, False):
        t = port_agent(jax_agent(), use_kernel=use)
        env = JitEnvironment(t, env_from({"rate": np.float32(0)}, "cpu"),
                             encoder, t_reward, t_update)
        runs.append((env.run_with_reward(STEPS), t))
    (ra, a), (rb, b) = runs
    np.testing.assert_allclose(ra, rb, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(a.state["gap_conductance"].numpy(),
                               b.state["gap_conductance"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(a.state["v"].numpy(), b.state["v"].numpy(),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(a.state["last_firing_time"].numpy(),
                                  b.state["last_firing_time"].numpy())


def test_structure_changes_raise():
    t = port_agent(jax_agent(), use_kernel=True)
    env = JitEnvironment(t, env_from({"rate": np.float32(0)}, "cpu"),
                         lambda e, s: {"v": s["v"]}, t_reward, t_update)
    with pytest.raises(ValueError):
        env.run_with_reward(2)
    env = JitEnvironment(t, env_from({"rate": np.float32(0)}, "cpu"),
                         t_encoder, t_reward, lambda e, s: {"x": e["rate"]})
    with pytest.raises(ValueError):
        env.run_with_reward(2)


def test_env_from_and_runner_cache():
    tree = {"a": np.float32(1.5), "b": [np.float32(2), (np.float32(3),)]}
    got = env_from(tree, "cpu")
    assert got["a"].dtype == torch.float32 and got["a"].dim() == 0
    assert isinstance(got["b"], list) and isinstance(got["b"][1], tuple)
    assert float(got["b"][1][0]) == 3.0
    t = port_agent(jax_agent(), use_kernel=True)
    env = port_env(t)
    for k in range(10):
        t.reward_modulator.params["a_plus"] = 0.02 + 0.001 * k
        env.run_with_reward(1)
    assert len(env._runners) == env._runners_max == 8


def test_gate_needs_the_kernel_class():
    """An agent outside the kernel's class (chemical synapses) takes the
    plain route even with ``use_kernel=True``; auto takes the plain route
    on the CPU."""
    t = port_agent(jax_agent(), use_kernel=True)
    t.chemical_synapse = True
    env = port_env(t)
    env.run_with_reward(2)
    assert not env.last_build_fused
    t = port_agent(jax_agent(), use_kernel=None)
    env = port_env(t)
    env.run_with_reward(2)
    assert not env.last_build_fused
    assert rk.ENV_LAUNCHES == 0


# -- on a CUDA card only ------------------------------------------------------


@pytest.mark.cuda
def test_cuda_closed_loop_equals_cpu():
    """Tier (a) on the card (graph replays) against the same tier on the
    CPU: bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    j = jax_agent()
    runs = []
    for dev in ("cuda", "cpu"):
        t = port_agent(j, use_kernel=True)
        t.state = {k: x.to(dev) for k, x in t.state.items()}
        t.graph = snt.convert.graph_from(j.graph, dev)
        t.trace = {k: x.to(dev) for k, x in t.trace.items()}
        env = JitEnvironment(t, env_from({"rate": np.float32(0)}, dev),
                             t_encoder, t_reward, t_update)
        runs.append((env.run_with_reward(40), t, env))
    (ra, a, ea), (rb, b, _) = runs
    assert ea.last_build_env_fused
    np.testing.assert_array_equal(ra, rb)
    for k in a.state:
        torch.testing.assert_close(a.state[k].cpu(), b.state[k], rtol=0,
                                   atol=0)

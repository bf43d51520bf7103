"""The reward arm of the network kernels: its plain twin
(`network_kernels.network_steps_reference`, taken by ``use_kernel=True``
on the CPU) against the JAX package's fused kernel (`pallas_reward.
network_runner`, `_fused_chunk` in interpret mode, ``use_pallas=True``),
on the reward networks of ``tests/test_pallas_reward.py``; the gate, case
by case against the JAX gate; the wrapper's checks; and the CUDA kernels
against the twin on a card.

Tolerance: v, weights, traces and dopamine within rtol 1e-5, atol 1e-4,
firing times, spikes and counters equal.  The twin takes the CUDA
kernels' `kernel_exp` where the JAX kernel takes XLA's exp (an ulp apart),
and the dopamine grows to ~1e3 under a reward of 0.5.  On the card the
kernels equal the twin bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
from spiking_neural_networks_tpu_torch.core.reward_structured import (
    resolve_reward_plan)
from spiking_neural_networks_tpu_torch.ops import network_kernels as nk
from torch_networks import (assert_reward_networks_match, both_reward,
                            reward_net)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4


@pytest.mark.parametrize("model,steps", [("izhikevich", 100), ("alif", 90)])
def test_twin_matches_tpu_kernel(model, steps):
    """The bench topology (reward lattice, plastic lattice, Rate train,
    a plain and a reward connection), 16-step calls plus a remainder."""
    j, t = both_reward(lambda: reward_net("rate", model), True, True)
    j.run_lattices_with_reward(0.5, steps)
    t.run_lattices_with_reward(0.5, steps)
    assert j._last_run_fused and t._last_run_fused == ("reward", False)
    assert nk.REWARD_LAUNCHES == 0          # the CPU takes the twin
    assert_reward_networks_match(t, j, RTOL, ATOL)
    assert bool((t.lattices[1].state["last_firing_time"] >= 0).any())


def test_twin_without_reward_keeps_the_dopamine():
    j, t = both_reward(lambda: reward_net("rate"), True, True)
    for net in (j, t):
        net.dopamine = 0.3
        net.run_lattices(40)
    assert t._last_run_fused == ("reward", False)
    assert t.dopamine == pytest.approx(0.3)
    assert_reward_networks_match(t, j, RTOL, ATOL)


def test_twin_matches_tpu_kernel_on_a_reward_schedule():
    """A schedule of rewards, a reward connection from the train into the
    reward lattice (static 1, a train's previous firing times) and one
    from the reward lattice into the plastic lattice (static 1 and a
    plastic post)."""
    def build():
        net = reward_net("rate", seed=5)
        net.connect_with_reward_modulation(2, 0, lambda a, b: a == b,
                                           lambda a, b: 2.0)
        net.connect_with_reward_modulation(0, 1, lambda a, b: a == b,
                                           lambda a, b: 0.5)
        return net

    rewards = np.where(np.arange(70) % 5 < 3, 0.4, -0.3).astype(np.float32)
    j, t = both_reward(build, True, True)
    j.run_lattices_with_reward(jnp.asarray(rewards), 70)
    t.run_lattices_with_reward(rewards, 70)
    assert j._last_run_fused and t._last_run_fused == ("reward", False)
    assert_reward_networks_match(t, j, RTOL, ATOL)


def _pool_conn(net):
    """A second, half-size plastic lattice pooled from lattice 1: a
    resample connection."""
    side = net.lattices[1].rows
    lat = snn.Lattice(net.lattices[1].model, id=3)
    lat.populate(side // 2, side // 2, gap_conductance=10.0)
    lat.connect_stencil(radius=1.0, seed=6)
    net.add_lattice(lat)
    net.connect_vectorized(1, 3, lambda pr, pc, qr, qc: np.where(
        (pr // 2 == qr) & (pc // 2 == qc), 0.5, np.nan))
    return net


def _dense_reward_lattice(net):
    lat = net.reward_modulated_lattices[0]
    n = lat.rows * lat.cols
    mask = np.random.default_rng(1).random((n, n)) < 0.3
    np.fill_diagonal(mask, False)
    from spiking_neural_networks_tpu.ops.graph import DenseGraph
    lat.graph = DenseGraph(jnp.asarray(np.where(mask, 1.0, 0.0),
                                       jnp.float32), jnp.asarray(mask))
    lat._reset_trace()
    return net


def _chemical(net):
    net.electrical_synapse = True
    net.chemical_synapse = True
    return net


def _unmodulated(net):
    net.reward_modulated_lattices[0].do_modulation = False
    return net


def _preset_train(net):
    st = snn.SpikeTrainLattice(snn.PresetSpikeTrain(), id=2)
    st.populate(8, 8, firing_times=[0.3, 0.5, 1.1])
    net.spike_train_lattices[2] = st
    return net


REFUSED = {"chemical": _chemical, "unmodulated": _unmodulated,
           "resample": _pool_conn, "dense-graph": _dense_reward_lattice,
           "preset-train": _preset_train}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_gate_refuses_what_the_jax_gate_refuses(name):
    """Each configuration outside the JAX kernel's class goes to the plain
    route in the port, with ``use_kernel=True``, and still matches the
    JAX package's own fallback."""
    j, t = both_reward(lambda: REFUSED[name](reward_net("rate")), True, True)
    j.run_lattices_with_reward(0.5, 20)
    t.run_lattices_with_reward(0.5, 20)
    assert not j._last_run_fused and t._last_run_fused is False
    assert_reward_networks_match(t, j, RTOL, ATOL)


def test_gate_and_plan():
    """The spec of the bench topology: kinds, static counts, plain
    connections first, the dopamine flag; no history on the kernel
    route."""
    _, t = both_reward(lambda: reward_net("rate"), False, True)
    plan = resolve_reward_plan(t)
    spec = nk.reward_network_spec(t, plan, ("mod", "plastic"), True, True)
    assert [ls.kind for ls in spec.lattices] == ["mod", "plastic"]
    assert [(c.pre_is_st, c.reward, c.static, c.pre_plastic,
             c.post_plastic) for c in spec.conns] == [
        (True, False, 0, False, True), (False, True, 1, True, False)]
    assert spec.with_reward and nk.is_reward(spec)
    assert resolve_reward_plan(t) is plan
    t.lattices[1].update_grid_history = True
    t.run_lattices_with_reward(0.5, 3)
    assert t._last_run_fused is False
    t.lattices[1].update_grid_history = False
    t.run_lattices_with_reward(0.5, 3)
    assert t._last_run_fused == ("reward", False)


def _call_args():
    _, t = both_reward(lambda: reward_net("rate"), False, True)
    plan = resolve_reward_plan(t)
    spec = nk.reward_network_spec(t, plan, ("mod", "plastic"), True, True)
    lats, trains, conns = nk.member_inputs(spec, t, plan)
    reward = dict(rule=t.reward_modulator.params,
                  dopamine=torch.tensor(0.25),
                  rewards=np.linspace(-0.2, 0.6, 7).astype(np.float32))
    return dict(spec=spec, lats=lats, trains=trains, conns=conns,
                uniforms=[None], rule=t._plasticity().params, clock0=3,
                n_steps=7, reward=reward)


def test_wrapper_rejects_what_the_reward_arm_does_not_take():
    args = _call_args()
    spec = args["spec"]

    def call(**kw):
        return nk.network_steps(**{**args, **kw})

    lats = [dict(d) for d in args["lats"]]
    lats[0]["traces"] = {**lats[0]["traces"],
                         "counter": lats[0]["traces"]["counter"].long()}
    conns = [dict(d) for d in args["conns"]]
    del conns[1]["c"]
    bad = [dict(reward=None), dict(lats=lats), dict(conns=conns),
           dict(reward={**args["reward"], "dopamine": torch.tensor([0.2])}),
           dict(reward={**args["reward"], "rewards": np.zeros(3)}),
           dict(spec=spec._replace(conns=(
               spec.conns[0], spec.conns[1]._replace(op=("dense",)))))]
    for kw in bad:
        with pytest.raises(ValueError):
            call(**kw)
    rule = {k: v for k, v in args["reward"]["rule"].items() if k != "tau_c"}
    with pytest.raises(KeyError):
        call(reward={**args["reward"], "rule": rule})


def test_twin_leaves_its_inputs_and_reports_the_dopamine():
    args = _call_args()
    before = {k: v.clone() for k, v in args["lats"][0]["traces"].items()}
    w0 = args["conns"][1]["w"].clone()
    lat_out, _, conn_ws, extra = nk.network_steps(**args)
    for k, v in before.items():
        assert torch.equal(args["lats"][0]["traces"][k], v)
    assert torch.equal(args["conns"][1]["w"], w0)
    want = torch.tensor(0.25)
    rule = nk.rule_tensors(args["reward"]["rule"], "cpu")
    for r in args["reward"]["rewards"]:
        want = want * rule["exp_dd"] + rule["tau_d"] * torch.tensor(float(r))
    assert float(extra["dopamine"]) == float(want)
    assert extra["traces"][0] is None and extra["traces"][1] is not None
    assert lat_out[0]["traces"] is not None and lat_out[1]["traces"] is None


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [16, 7])
def test_kernels_equal_twin_on_card(n_steps, monkeypatch):
    """On a GPU: the reward arm against the twin, bit for bit, through the
    persistent kernel with every member resident in shared memory and
    with every member streamed, and through the per-step design."""
    _needs_cuda()
    args = _call_args()
    rewards = np.linspace(-0.2, 0.6, n_steps).astype(np.float32)

    def cuda(d):
        return {k: (v.cuda() if isinstance(v, torch.Tensor) else
                    {q: p.cuda() for q, p in v.items()}
                    if isinstance(v, dict) else v) for k, v in d.items()}

    args.update(lats=[cuda(d) for d in args["lats"]],
                trains=[cuda(d) for d in args["trains"]],
                conns=[cuda(d) for d in args["conns"]], n_steps=n_steps,
                reward={**args["reward"], "rewards": rewards,
                        "dopamine": args["reward"]["dopamine"].cuda()})
    assert nk.uses_persistent(args["spec"])
    want = nk.network_steps_reference(**args)
    budget = nk.SMEM_BUDGET
    for smem, per_step in ((budget, False), (0, False), (budget, True)):
        monkeypatch.setattr(nk, "SMEM_BUDGET", smem)   # 0: all streamed
        before = nk.PERSISTENT_LAUNCHES
        got = nk.network_steps(**args, per_step=per_step)
        torch.cuda.synchronize()
        assert nk.PERSISTENT_LAUNCHES == before + (not per_step)
        for g, w in zip(got[0], want[0]):
            for k in ("v", "w", "lft", "spikes", "weights"):
                torch.testing.assert_close(g[k], w[k], rtol=0, atol=0)
            if w["traces"] is not None:
                for k, v in w["traces"].items():
                    torch.testing.assert_close(g["traces"][k], v, rtol=0,
                                               atol=0)
        for g, w in zip(got[2], want[2]):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        for g, w in zip(got[3]["traces"], want[3]["traces"]):
            if w is not None:
                for k, v in w.items():
                    torch.testing.assert_close(g[k], v, rtol=0, atol=0)
        torch.testing.assert_close(got[3]["dopamine"], want[3]["dopamine"],
                                   rtol=0, atol=0)

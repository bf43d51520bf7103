"""The closed loop's fused order (``csrc/lattice_plasticity.cu``'s
``lattice_plasticity_env_step``, `reward_kernels.EnvChain`) on the CPU: a
plain PyTorch replay of what each launch reads and writes, driven through
the chain that the CUDA launcher uses, held against today's sequence of
`env_step_launcher_reference` steps bit for bit, and inside the closed
loop against the JAX package's env-fused kernel in interpret mode.

Launch k runs step k-1's edge pass, deferred across the callbacks, from
the firing times and spike flags that step k-1 kept in the chain's
private plane (k-1) % 2 and the dopamine in slot (k-1) % 2, then step k's
phases A and B from the state planes (which the callbacks may have
written), keeping its firing times and flags in plane k % 2; block 0
writes the dopamine with step k's reward and the clock + 1 into the other
slot.  A flush runs the last step's edge pass and moves the scalars back
to slot 0.  On a card, the CUDA entry against the twin: the ``cuda``
tests below and in ``tests/test_torch_env_kernel.py``.

Tolerance: bit for bit against the twin (floats compared as their int32
bits); against the JAX kernel those of ``tests/test_torch_interactable.py``.
"""

import itertools

import numpy as np
import pytest
import torch

from spiking_neural_networks_tpu_torch.core.plasticity import rule_tensors
from spiking_neural_networks_tpu_torch.ops import reward_kernels as rk
from spiking_neural_networks_tpu_torch.ops.reward_kernels import (
    model_step, shifted)
from test_torch_interactable import (assert_agents_match, jax_agent,
                                     jax_env, port_agent, port_env)
from test_torch_plasticity_schedule import _edge_pass
from torch_lattices import bits_equal, schedule_inputs

torch.set_num_threads(1)

CALLS = (16, 16, 5)        # two graph-sized calls and a remainder
KINDS = [(model, kind, rew) for model in ("izhikevich", "alif", "lif")
         for kind, rew in (("plastic", False), ("mod", True),
                           ("mod", False))]


# -- the replay ---------------------------------------------------------------


def replay_launcher(spec, src, dst, spikes, weights, mask, in_deg, params,
                    traces, dopamine, rule, clock, chain=None,
                    _public=False):
    """`env_step_launcher` with whole-plane PyTorch in place of the CUDA
    entry: the launch of each step through ``chain`` (the CUDA launcher's
    `EnvChain` protocol), each run doing what the kernel does with the
    `EnvLaunch` it is given.  Counts one launch per run in the chain.
    ``_public`` makes the edge pass read the state planes instead of the
    kept ones (a fault the tests must see)."""
    r = rule_tensors(rule, src[0].device)
    p = {k: params[k] for k in rk.MODEL_PARAM_KEYS[spec.model]}
    masks = list(mask.unbind(0)) if spec.kind != "plain" else None

    def run(how, reward):
        # read from the buffers at each launch, as the kernel reads them
        chain.launched += 1
        cnt = torch.clamp(in_deg, min=1.0)
        ws = list(weights.unbind(0))
        if how.edge:
            tr = tuple(list(t.unbind(0)) for t in traces) \
                if spec.kind == "mod" else None
            lft_e, spk_e = ((src if how.cell else dst)[2], spikes) \
                if _public else (how.lft_edge, how.spk_edge)
            _edge_pass(spec.kind, spec.offsets, r, lft_e, spk_e, ws, masks,
                       tr, how.dop_read)
            weights.copy_(torch.stack(ws))
            if tr is not None:
                for t, x in zip(traces, tr):
                    t.copy_(torch.stack(x))
        if how.cell:
            v, w, lft, refr = src
            acc = torch.zeros_like(v)
            wsum = torch.zeros_like(v)
            for o, vs in enumerate(shifted(v, spec.offsets, 0.0)):
                acc = acc + ws[o] * vs
                wsum = wsum + ws[o]
            i_syn = p["gap_conductance"] * (acc - v * wsum) / cnt
            nv, nw, nr, spk, _ = model_step(spec.model, p, v, w, refr,
                                            i_syn)
            nl = torch.where(spk, how.clock_read[0], lft)
            for t, x in zip(dst, (nv, nw, nl, nr)):
                if t is not None:
                    t.copy_(x)
            spikes.copy_(spk)
            how.lft_keep.copy_(nl)
            how.spk_keep.copy_(spk)
        if how.dop_write is not None:
            d = how.dop_read
            if reward is not None:
                d = d * r["exp_dd"] + r["tau_d"] * reward
            how.dop_write.copy_(d)
        if how.clock_write is not None:
            how.clock_write.copy_(how.clock_read + int(how.cell))

    def launch(reward=None):
        chain.step(run, spec.kind != "plain",
                   reward if spec.with_reward else None)

    return launch


# -- a loop of launchers and callbacks ----------------------------------------


def buffers(a):
    src = tuple(None if x is None else x.clone()
                for x in (a["v"], a["w"], a["lft"], a["refr"]))
    return dict(src=src, dst=tuple(None if x is None else torch.zeros_like(x)
                                   for x in src),
                spikes=torch.zeros_like(a["v"], dtype=torch.bool),
                weights=a["weights"].clone(),
                traces=None if a["traces"] is None
                else tuple(t.clone() for t in a["traces"]),
                dopamine=a["dopamine"].clone(),
                clock=torch.tensor([a["clock0"]], dtype=torch.int32,
                                   device=a["v"].device))


def outputs(b, planes):
    """Copies of a loop's state by name (None where the kind has none)."""
    names = ("v", "w", "lft", "refr", "spikes", "weights", "dopamine",
             "clock", "c", "dw", "counter")
    xs = list(planes) + [b["spikes"], b["weights"], b["dopamine"],
                         b["clock"]] + list(b["traces"] or (None,) * 3)
    return {k: None if x is None else x.clone() for k, x in zip(names, xs)}


def same(got, want):
    return all(bits_equal(got[k], want[k]) for k in want)


def loop(make, a, calls, chain=None):
    """``calls`` calls of chained steps of ``make``'s launchers between
    two plane sets, each reward computed from the state the step receives,
    each step followed by callbacks that write v, the firing times and the
    spike flags of the state it left (the random choices from one seed, on
    the host); a flush of ``chain`` ends each call.  Returns the outputs
    after each call."""
    b = buffers(a)
    planes = [b["src"], b["dst"]]
    kw = {} if chain is None else dict(chain=chain(b))
    launch = [make(a["spec"], planes[p], planes[1 - p], b["spikes"],
                   b["weights"], a["mask"], a["in_deg"], a["params"],
                   b["traces"], b["dopamine"], a["rule"], b["clock"], **kw)
              for p in (0, 1)]
    rng = np.random.default_rng(3)
    dev = a["v"].device

    def some(frac):
        return torch.from_numpy(rng.random(tuple(a["v"].shape)) < frac
                                ).to(dev)

    k, outs = 0, []
    for n in calls:
        for _ in range(n):
            p = k % 2
            reward = (0.05 - 0.001 * planes[p][0].mean()
                      + 0.1 * b["spikes"].to(torch.float32).mean()
                      ).reshape(())
            launch[p](reward)
            v, _, lft, _ = planes[1 - p]
            v.add_(torch.where(some(0.1), 3.0, 0.0))
            lft.masked_fill_(some(0.05), a["clock0"] + k - 1)
            b["spikes"].logical_xor_(some(0.1))
            k += 1
        if chain is not None:
            kw["chain"].flush()
        outs.append(outputs(b, planes[k % 2]))
    return outs, kw.get("chain")


def new_chain(per_step=False):
    return lambda b: rk.EnvChain(b["dopamine"], b["clock"],
                                 tuple(b["spikes"].shape), per_step)


@pytest.mark.parametrize("model,kind,with_reward", KINDS)
def test_replay_matches_twin_with_writing_callbacks(model, kind,
                                                    with_reward):
    """Calls of 16, 16 and 5 steps whose callbacks write v, the firing
    times and the spike flags every step: every output of every call bit
    for bit equal to the twin's steps, with -0.0 weights and counters of
    2; 17 launches per 16 steps, 6 for the 5."""
    a = schedule_inputs(kind, model, with_reward, seed=len(model))
    got, chain = loop(replay_launcher, a, CALLS, new_chain())
    want, _ = loop(rk.env_step_launcher_reference, a, CALLS)
    assert all(same(g, w) for g, w in zip(got, want))
    assert chain.launched == 17 + 17 + 6
    assert chain.due is None and chain.parity == 0
    moved = want[-1]["weights"].view(torch.int32) \
        != a["weights"].view(torch.int32)
    assert moved.any()
    assert (want[-1]["lft"] >= a["clock0"]).any()      # spikes in the run


def test_the_edge_pass_reads_the_kept_planes():
    """The deferred pass must read step k-1's own firing times, not the
    state planes that a callback wrote: the replay reading the state
    planes instead parts from the twin."""
    a = schedule_inputs("plastic", "izhikevich", False, seed=5)

    def public(*args, chain=None):
        return replay_launcher(*args, chain=chain, _public=True)

    got, _ = loop(public, a, (16,), new_chain())
    want, _ = loop(rk.env_step_launcher_reference, a, (16,))
    assert not bits_equal(got[0]["weights"], want[0]["weights"])
    kept, _ = loop(replay_launcher, a, (16,), new_chain())
    assert same(kept[0], want[0])


@pytest.mark.parametrize("kind,with_reward", [("plain", True),
                                              ("plain", False)])
def test_replay_without_plasticity(kind, with_reward):
    """Kind ``plain``: one launch a step, no edge pass; a call of an odd
    count of steps ends with one launch that moves the dopamine and the
    clock back into slot 0."""
    a = schedule_inputs(kind, "lif", with_reward, seed=7)
    got, chain = loop(replay_launcher, a, CALLS, new_chain())
    want, _ = loop(rk.env_step_launcher_reference, a, CALLS)
    assert all(same(g, w) for g, w in zip(got, want))
    assert chain.launched == 16 + 16 + 5 + 1


def test_per_step_chain_flushes_every_step():
    """The design without the deferral (``per_step``): two launches a
    step, the same bits."""
    a = schedule_inputs("mod", "alif", True, seed=9)
    got, chain = loop(replay_launcher, a, (16, 5), new_chain(True))
    want, _ = loop(rk.env_step_launcher_reference, a, (16, 5))
    assert all(same(g, w) for g, w in zip(got, want))
    assert chain.launched == 2 * 21


def test_chain_slots_and_parity():
    """Launch k reads slot k % 2 and writes the other; a flush after an
    odd count writes slot 0 and one after an even count writes nothing;
    the due step and the parity are forgotten by a flush and a reset."""
    dop, clock = torch.tensor(0.5), torch.tensor([3], dtype=torch.int32)
    chain = rk.EnvChain(dop, clock, (2, 3))
    runs = []

    def run(how, reward):
        runs.append(how)

    chain.step(run, True, None)
    chain.step(run, True, None)
    first, second = runs
    assert not first.edge and second.edge
    assert first.clock_read is clock and first.clock_write is chain.clock[1]
    assert second.clock_read is chain.clock[1] and second.clock_write is clock
    assert first.dop_read is dop and first.dop_write is chain.dop[1]
    assert first.lft_keep.data_ptr() == chain.lft[0].data_ptr()
    assert second.lft_edge.data_ptr() == chain.lft[0].data_ptr()
    chain.flush()
    assert len(runs) == 3 and runs[2].edge and not runs[2].cell
    assert runs[2].dop_write is None and runs[2].clock_write is None
    chain.step(run, False, None)
    chain.flush()
    assert not runs[3].edge
    assert runs[4].clock_read is chain.clock[1]
    assert runs[4].clock_write is clock and not runs[4].cell
    chain.step(run, True, None)
    chain.reset()
    chain.flush()
    assert len(runs) == 6 and chain.due is None and chain.parity == 0


def test_launcher_on_cpu_leaves_the_chain_idle():
    """On CPU tensors the launcher is the twin's, which runs each step
    whole: the chain launches nothing and has nothing to flush."""
    a = schedule_inputs("mod", "lif", True)
    b = buffers(a)
    chain = rk.EnvChain(b["dopamine"], b["clock"], tuple(a["v"].shape))
    launch = rk.env_step_launcher(
        a["spec"], b["src"], b["dst"], b["spikes"], b["weights"], a["mask"],
        a["in_deg"], a["params"], b["traces"], b["dopamine"], a["rule"],
        b["clock"], chain)
    launch(torch.tensor(0.1))
    chain.flush()
    assert chain.launched == 0 and int(b["clock"]) == a["clock0"] + 1


# -- the closed loop ----------------------------------------------------------


def test_closed_loop_with_the_fused_order_matches_jax(monkeypatch):
    """`JitEnvironment` on a 12 x 16 R-STDP agent with the replay in
    place of the CUDA entry (its chain, flushes and probe as on a card;
    tier (b) on the CPU), in calls of 16, 16 and 5 steps, against the JAX
    package's env-fused kernel in interpret mode over 37 steps."""
    monkeypatch.setattr(rk, "env_step_launcher", replay_launcher)
    j = jax_agent("izhikevich", rows=12, cols=16, use_pallas=True)
    t = port_agent(j, "izhikevich", use_kernel=True)
    je, te = jax_env(j), port_env(t)
    rj = je.run_with_reward(sum(CALLS))
    rt = np.concatenate([te.run_with_reward(n) for n in CALLS])
    assert je.last_build_env_fused and te.last_build_fused
    loop_ = next(iter(te._runners.values()))
    assert loop_.chain.launched == 17 + 17 + 6 + 2    # + the probe's step
    np.testing.assert_allclose(rt, rj, rtol=1e-6, atol=1e-6)
    assert_agents_match(t, j, te, je)
    assert (t.state["last_firing_time"] > 3).any()


def test_probe_restores_the_chain(monkeypatch):
    """The capture probe runs a step and a flush and restores every
    buffer it touched, the chain's private planes and slots included, and
    forgets the due step."""
    monkeypatch.setattr(rk, "env_step_launcher", replay_launcher)
    t = port_agent(jax_agent("alif", rows=6, cols=7), "alif",
                   use_kernel=True)
    env = port_env(t)
    env.run_with_reward(3)
    lp = next(iter(env._runners.values()))
    lp.chain.lft.fill_(7)
    before = [b.clone() for b in lp.buffers()]
    assert lp.probe()
    assert lp.chain.launched == 2 + 2 + 4
    after = lp.buffers()
    assert len(after) == len(before)
    assert all(bits_equal(x, y) for x, y in zip(after, before))
    assert lp.chain.due is None and lp.chain.parity == 0


# -- on a CUDA card only ------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("model,kind,with_reward,k,per_step", [
    (m, kd, r, k, ps) for (m, kd, r), k, ps in itertools.product(
        KINDS + [("lif", "plain", True)], (1, 2, 16, 17, 33),
        (False, True))])
def test_cuda_fused_entry_matches_twin(model, kind, with_reward, k,
                                       per_step):
    """The CUDA entry on a 33 x 70 grid (a partial last tile, -0.0
    weights, counters of 2), K steps and a flush, callbacks writing the
    state: bit-equal to the twin's steps, in both designs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    a = schedule_inputs(kind, model, with_reward, 33, 70, device="cuda")
    got, chain = loop(rk.env_step_launcher, a, (k,), new_chain(per_step))
    torch.cuda.synchronize()
    want, _ = loop(rk.env_step_launcher_reference, a, (k,))
    assert same(got[0], want[0])
    plastic = kind != "plain"
    assert chain.launched == (2 * k if per_step
                              else k + (plastic or k % 2))

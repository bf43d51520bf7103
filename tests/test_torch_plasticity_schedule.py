"""The fused schedule of the single-lattice plasticity kernel
(``csrc/lattice_plasticity.cu``) and of the HH kernel's STDP
(``csrc/hh_chemical.cu``) on the CPU: a plain PyTorch loop that replays
the kernels' order, held against the plain twins bit for bit and against
the JAX package's TPU kernel.

A K-step call is K + 1 launches: launch k runs step k-1's edge pass (STDP
or the R-STDP double visit, from step k-1's firing times, its spike
flags in parity plane (k-1) % 2 and its dopamine) on every destination's
own slots, then step k's phase A from the weights that pass left and
phase B, writing step k's spike flags into plane k % 2; launch K is
step K-1's edge pass alone.  The pass stores a value only where its bits
changed, and each launch folds the rewards of its step into the dopamine.
The twins run each step's phases in the TPU kernel's order; so this ties
the fused order to the JAX package before a card sees it.  On a card, the
kernels against the twins: the ``cuda``-marked tests of
``tests/test_torch_reward_kernel.py``, ``tests/test_torch_hh_kernel.py``
and ``tests/test_torch_env_kernel.py``.

Tolerance: bit for bit against the twins (floats compared as their int32
bits, so +0.0 and -0.0 apart); against the JAX kernel rtol 1e-6, atol
1e-5, as ``tests/test_torch_reward_kernel.py`` (XLA's CPU backend rounds
some exps and multiply-adds otherwise).
"""

import numpy as np
import pytest
import torch

import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu_torch.core.plasticity import (
    kernel_exp, rstdp_visit, rule_tensors, stdp_delta)
from spiking_neural_networks_tpu_torch.models.base import NEVER
from spiking_neural_networks_tpu_torch.ops import hh_kernels as hk
from spiking_neural_networks_tpu_torch.ops import reward_kernels as rk
from spiking_neural_networks_tpu_torch.ops.reward_kernels import (
    model_step, shifted)
from torch_lattices import (assert_lattices_match, bits_equal,
                            hh_schedule_inputs, jax_lattice, port_of,
                            schedule_inputs)

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-5
CALLS = (16, 16, 5)            # chained calls: two full ones and a remainder


# -- the replay ---------------------------------------------------------------


def _store_changed(new, old):
    """The kernels' conditional store: ``new`` where its bits differ from
    ``old``, else ``old`` (which holds the same bits)."""
    if new.dtype == torch.float32:
        diff = new.view(torch.int32) != old.view(torch.int32)
    else:
        diff = new != old
    return torch.where(diff, new, old)


def _edge_pass(kind, offsets, r, lft, spk, ws, masks, tr, dop):
    """One step's edge pass on whole planes, in place on the lists ``ws``
    and ``tr`` (one plane per offset): the post-step ``lft`` and spike
    flags ``spk`` of both endpoints, off-grid neighbours NEVER and 0."""
    spk_f = spk.to(torch.float32)
    lft_pre = shifted(lft, offsets, NEVER)
    spk_pre = shifted(spk_f, offsets, 0.0)
    for o in range(len(offsets)):
        delta = stdp_delta(lft_pre[o], lft, r, kernel_exp)
        m = masks[o]
        if kind == "plastic":
            w = torch.where(m, ws[o] + delta * (spk_pre[o] + spk_f), ws[o])
            ws[o] = _store_changed(w, ws[o])
            continue
        tc, tdw, tct = tr
        w1, c1, d1, t1 = rstdp_visit(ws[o], tc[o], tdw[o], tct[o], delta,
                                     dop, r)
        w2, c2, d2, t2 = rstdp_visit(w1, c1, d1, t1, delta, dop, r)
        for planes, new in ((ws, w2), (tc, c2), (tdw, d2), (tct, t2)):
            planes[o] = _store_changed(torch.where(m, new, planes[o]),
                                       planes[o])


def fused_replay(spec, v, w, lft, refr, weights, mask, in_deg, params,
                 traces, dopamine, rule, rewards, clock0, n_steps):
    """`lattice_plasticity_steps`' fused schedule on whole planes: launch
    k runs step k-1's edge pass from the parity plane (k-1) % 2 of the
    spike flags and step k-1's firing times and dopamine, then step k's
    phases A and B into buffer set k % 2 and plane k % 2; launch
    ``n_steps`` the edge pass alone.  The dopamine of a step is folded in
    by the launch that takes it.  Returns the twin's layout."""
    r = rule_tensors(rule, v.device)
    p = {k: params[k] for k in rk.MODEL_PARAM_KEYS[spec.model]}
    cnt = torch.clamp(in_deg, min=1.0)
    ws = list(weights.unbind(0))
    masks = list(mask.unbind(0)) if spec.kind != "plain" else None
    tr = tuple(list(t.unbind(0)) for t in traces) \
        if spec.kind == "mod" else None
    n = int(n_steps)
    dops = []
    for k in range(n):
        d = dopamine if k == 0 else dops[-1]
        if spec.with_reward:
            d = d * r["exp_dd"] + r["tau_d"] * torch.tensor(
                float(np.float32(rewards[k])))
        dops.append(d)
    sets = [None, None]          # step state by parity
    spikes = [None, None]        # spike flags by parity
    v_pres = []
    for k in range(n + 1):
        if k > 0 and spec.kind != "plain":
            prev = sets[(k - 1) % 2]
            _edge_pass(spec.kind, spec.offsets, r, prev[2],
                       spikes[(k - 1) % 2], ws, masks, tr, dops[k - 1])
        if k == n:
            break
        sv, sw, sl, sr = (v, w, lft, refr) if k == 0 else sets[(k - 1) % 2]
        acc = torch.zeros_like(sv)
        wsum = torch.zeros_like(sv)
        for o, vs in enumerate(shifted(sv, spec.offsets, 0.0)):
            acc = acc + ws[o] * vs
            wsum = wsum + ws[o]
        i_syn = p["gap_conductance"] * (acc - sv * wsum) / cnt
        nv, nw, nr, spk, v_pre = model_step(spec.model, p, sv, sw, sr, i_syn)
        sets[k % 2] = (nv, nw, sl.masked_fill(spk, int(clock0) + k), nr)
        spikes[k % 2] = spk
        v_pres.append(v_pre)
    last = sets[(n - 1) % 2]
    return (last[0], last[1], last[2], last[3], spikes[(n - 1) % 2],
            torch.stack(ws) if spec.kind != "plain" else weights,
            tuple(torch.stack(t) for t in tr) if spec.kind == "mod"
            else traces,
            dops[-1] if spec.with_reward else dopamine,
            torch.stack(v_pres) if spec.emit else None)


def fused_hh_replay(state, weights, mask, in_deg, offsets, clock0, n_steps,
                    electrical, nt_kind, rec_kind, rule=None):
    """`hh_steps`' fused schedule: launch k runs step k-1's STDP pass from
    the state's post-step firing times and spike flags, then step k's
    cell phase (the twin's step without plasticity) from the weights that
    pass left; an edge launch follows the last step."""
    r = rule_tensors(rule, in_deg.device)
    shape = tuple(in_deg.shape)
    masks = list(mask.unbind(0))
    ws = list(weights.unbind(0))
    st = state
    for k in range(int(n_steps) + 1):
        if k > 0:
            _edge_pass("plastic", offsets, r,
                       st["last_firing_time"].reshape(shape),
                       st["is_spiking"].reshape(shape), ws, masks, None,
                       None)
        if k == int(n_steps):
            break
        st, _ = hk.hh_steps_reference(st, torch.stack(ws), mask, in_deg,
                                      offsets, int(clock0) + k, 1,
                                      electrical, nt_kind, rec_kind, None)
    return st, torch.stack(ws)


# -- inputs -------------------------------------------------------------------


def chained(fn, args):
    """``CALLS`` chained calls of ``fn`` from ``args``; the outputs of
    each call."""
    a, done, outs = dict(args), 0, []
    for n in CALLS:
        out = fn(**dict(a, n_steps=n, clock0=args["clock0"] + done,
                        rewards=None if args["rewards"] is None
                        else args["rewards"][done:done + n]))
        outs.append(out)
        a.update(v=out[0], w=out[1], lft=out[2], refr=out[3],
                 weights=out[5], traces=out[6], dopamine=out[7])
        done += n
    return outs


KINDS = [(kind, model, rew) for model in ("izhikevich", "alif", "lif")
         for kind, rew in (("plastic", False), ("mod", True), ("mod", False))]


@pytest.mark.parametrize("kind,model,with_reward", KINDS)
def test_replay_matches_twin(kind, model, with_reward):
    """Calls of 16, 16 and 5 steps: every output of every call, the
    emitted pre-reset voltages included, equal bit for bit."""
    args = schedule_inputs(kind, model, with_reward, seed=len(model))
    got = chained(fused_replay, args)
    want = chained(rk.lattice_plasticity_steps_reference, args)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert bits_equal(x, y)
    assert (want[-1][2] >= 100).any()                  # spikes in the run
    moved = want[-1][5].view(torch.int32) != args["weights"].view(torch.int32)
    assert moved.any()


@pytest.mark.parametrize("with_reward", [True, False])
def test_replay_matches_twin_plain(with_reward):
    """Kind ``plain``: K launches, no edge pass; the dopamine still takes
    the rewards."""
    args = schedule_inputs("plain", "lif", with_reward, seed=7)
    for g, w in zip(chained(fused_replay, args),
                    chained(rk.lattice_plasticity_steps_reference, args)):
        assert all(bits_equal(x, y) for x, y in zip(g, w))


def test_conditional_stores_keep_the_sign_rule():
    """A -0.0 weight on a masked slot whose delta is 0 becomes +0.0 (w + 0
    rounds to +0.0), and masked counters of 2 come out as the twin gives
    them (1): both are stores of changed bits."""
    args = schedule_inputs("mod", "izhikevich", True, seed=3)
    neg = args["weights"].view(torch.int32) == torch.tensor(
        -0.0).view(torch.int32)
    assert (neg & args["mask"]).any()
    assert (args["traces"][2][args["mask"]] == 2).any()
    out = fused_replay(**dict(args, n_steps=1, rewards=args["rewards"][:1]))
    want = rk.lattice_plasticity_steps_reference(
        **dict(args, n_steps=1, rewards=args["rewards"][:1]))
    assert bits_equal(out[5], want[5]) and bits_equal(out[6], want[6])
    assert not (out[5].view(torch.int32)[neg & args["mask"]]
                == torch.tensor(-0.0).view(torch.int32)).all()
    assert not (out[6][2][args["mask"]] == 2).any()


def test_step_launches():
    spec = rk.LatSpec("mod", "izhikevich", ((0, 1),), with_reward=True)
    assert rk.step_launches(spec, 16) == 17
    assert rk.step_launches(spec, 16, per_step=True) == 33
    assert rk.step_launches(spec._replace(kind="plastic", with_reward=False),
                            16, per_step=True) == 32
    assert rk.step_launches(spec._replace(kind="plain"), 5) == 5
    assert rk.step_launches(spec, 17, per_step=True) == 36
    assert hk.step_launches(16, True) == 17
    assert hk.step_launches(16, True, per_step=True) == 32
    assert hk.step_launches(16, False) == 16


@pytest.mark.parametrize("kind,model,rows,cols,want", [
    ("plastic", "alif", 512, 512, True), ("plastic", "alif", 1024, 512, True),
    ("plastic", "alif", 256, 256, False), ("plastic", "alif", 511, 512, False),
    ("plastic", "izhikevich", 512, 512, False),
    ("plastic", "lif", 512, 512, False), ("mod", "alif", 512, 512, False),
    ("plain", "alif", 512, 512, False)])
def test_per_step_route(kind, model, rows, cols, want):
    """Only STDP on ALIF from 512 x 512 takes the per-step design, where
    it measured faster; every other spec the fused schedule."""
    spec = rk.LatSpec(kind, model, ((0, 1),), with_reward=kind == "mod")
    assert rk.per_step_route(spec, rows, cols) is want


@pytest.mark.parametrize("least,want", [(30, True), (31, False)])
def test_advance_takes_the_routed_design(least, want, monkeypatch):
    """`advance` passes `per_step_route`'s answer to every call, and the
    result is the twin's either way."""
    spec, state, graph, trace, rule, shape = _advance_args("plastic", "cpu")
    monkeypatch.setattr(rk, "PER_STEP_FROM",
                        {("izhikevich", "plastic"): least})
    seen, wrapper = [], rk.lattice_plasticity_steps

    def spy(*args, _per_step=False, **kw):
        seen.append(_per_step)
        return wrapper(*args, _per_step=_per_step, **kw)

    monkeypatch.setattr(rk, "lattice_plasticity_steps", spy)
    out = rk.advance(spec, state, graph, trace, torch.tensor(0.3), rule,
                     None, 3, 40, shape)
    assert seen == [want] * 3
    monkeypatch.setattr(rk, "PER_STEP_FROM", {})
    seen.clear()
    ref = rk.advance(spec, state, graph, trace, torch.tensor(0.3), rule,
                     None, 3, 40, shape)
    assert seen == [False] * 3
    assert bits_equal(out[1], ref[1])
    assert all(bits_equal(out[0][k], ref[0][k]) for k in ref[0])


@pytest.mark.parametrize("kind,model", [("plastic", "alif"),
                                        ("mod", "lif")])
def test_wrapper_options_on_cpu_run_the_twin(kind, model):
    """``_per_step`` and ``_own`` pick the design and the copy on CUDA;
    on the CPU the wrapper runs the twin whatever they say, and leaves its
    inputs as they were."""
    args = schedule_inputs(kind, model, kind == "mod", seed=11)
    args = dict(args, n_steps=5, rewards=None if args["rewards"] is None
                else args["rewards"][:5])
    w0 = args["weights"].clone()
    want = rk.lattice_plasticity_steps_reference(**args)
    for kw in (dict(_per_step=True), dict(_own=True)):
        got = rk.lattice_plasticity_steps(**args, **kw)
        assert all(bits_equal(x, y) for x, y in zip(got, want))
    assert bits_equal(args["weights"], w0)


# -- the HH kernel's STDP -----------------------------------------------------


@pytest.mark.parametrize("nt,rec", [("destexhe", "destexhe"),
                                    ("approximate", "approximate")])
def test_hh_replay_matches_twin(nt, rec):
    """The HH kernel's fused STDP schedule over calls of 16, 16 and 5
    steps against `hh_steps_reference`, bit for bit."""
    args = hh_schedule_inputs(nt=nt, rec=rec, seed=5)
    a, clock = dict(args), args["clock0"]
    for n in CALLS:
        got = fused_hh_replay(**dict(a, clock0=clock, n_steps=n))
        want = hk.hh_steps_reference(**dict(a, clock0=clock, n_steps=n))
        assert bits_equal(got[1], want[1])
        for key in hk.STATE_KEYS + hk.CURRENT_KEYS:
            assert bits_equal(got[0][key], want[0][key]), key
        a.update(state=want[0], weights=want[1])
        clock += n
    assert not bits_equal(a["weights"], args["weights"])
    assert (a["state"]["last_firing_time"] >= 100).any()


def test_hh_wrapper_options_on_cpu_run_the_twin():
    args = dict(hh_schedule_inputs(seed=2), n_steps=5)
    w0 = args["weights"].clone()
    want = hk.hh_steps_reference(**args)
    for kw in (dict(_per_step=True), dict(_own=True)):
        got = hk.hh_steps(**args, **kw)
        assert bits_equal(got[1], want[1])
        assert all(bits_equal(got[0][k], want[0][k]) for k in hk.STATE_KEYS)
    assert bits_equal(args["weights"], w0)


# -- against the JAX package ---------------------------------------------------


def _replay_wrapper(spec, v, w, lft, refr, weights, mask, in_deg, params,
                    traces, dopamine, rule, rewards, clock0, n_steps,
                    _per_step=False, _own=False):
    return fused_replay(spec, v, w, lft, refr, weights, mask, in_deg, params,
                        traces, dopamine, rule, rewards, clock0, n_steps)


@pytest.mark.parametrize("kind,model,with_reward", [
    ("plastic", "izhikevich", False), ("mod", "alif", True),
    ("mod", "lif", False)])
def test_replay_matches_tpu_kernel(kind, model, with_reward, monkeypatch):
    """12 x 16, radius 2, 37 steps (two K = 16 calls and 5): the port's
    runner with the replay in place of the wrapper against
    `_fused_chunk` in interpret mode (use_pallas=True)."""
    steps = sum(CALLS)
    j = jax_lattice(model, kind, 12, 16, seed=6, use_pallas=True)
    t = port_of(j, model, use_kernel=True)
    monkeypatch.setattr(rk, "lattice_plasticity_steps", _replay_wrapper)
    rewards = np.linspace(-0.1, 0.2, steps).astype(np.float32)
    for lat in (j, t):
        if kind == "mod" and with_reward:
            lat.run_lattice_with_reward(rewards, steps)
        else:
            lat.run_lattice(steps)
    assert t._last_run_fused in (("stdp", False), True)
    assert_lattices_match(t, j, RTOL, ATOL)
    assert (t.state["last_firing_time"] >= 3).any()


# -- the runner's copy ----------------------------------------------------------


def _advance_args(kind, device):
    j = jax_lattice("izhikevich", kind, 6, 5, seed=1)
    t = port_of(j, "izhikevich", use_kernel=True)
    shape = (6, 5)
    spec = rk.LatSpec(kind, "izhikevich", t.graph.offsets,
                      with_reward=kind == "mod")
    state = {k: x.to(device) for k, x in t.state.items()}
    g = t.graph
    graph = snt.StencilGraph(g.offsets, g.weights.to(device),
                             g.mask.to(device), g.in_deg.to(device))
    trace = {k: x.to(device) for k, x in t.trace.items()} \
        if kind == "mod" else None
    rule = t.plasticity.params if kind == "plastic" \
        else t.reward_modulator.params
    return spec, state, graph, trace, rule, shape


@pytest.mark.parametrize("kind", ["plastic", "mod"])
def test_advance_leaves_the_callers_tensors(kind):
    """2048 steps through `advance` (128 calls that update one copy in
    place on a card): the caller's weights and traces keep their bits."""
    spec, state, graph, trace, rule, shape = _advance_args(kind, "cpu")
    w0 = graph.weights.clone()
    tr0 = {k: x.clone() for k, x in (trace or {}).items()}
    rewards = np.full(2048, 0.01, np.float32) if kind == "mod" else None
    _, weights, trace1, _, _ = rk.advance(
        spec, state, graph, trace, torch.tensor(0.3), rule, rewards, 3,
        2048, shape)
    assert bits_equal(graph.weights, w0)
    for k, x in tr0.items():
        assert bits_equal(trace[k], x)
    assert not bits_equal(weights, w0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["plastic", "mod"])
def test_cuda_advance_leaves_the_callers_tensors(kind):
    """The same on the card, where the calls update the runner's copy in
    place: the caller's tensors keep their bits, and the run equals the
    CPU route's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    outs = []
    for device in ("cuda", "cpu"):
        spec, state, graph, trace, rule, shape = _advance_args(kind, device)
        w0 = graph.weights.clone()
        tr0 = {k: x.clone() for k, x in (trace or {}).items()}
        rewards = np.full(2048, 0.01, np.float32) if kind == "mod" else None
        out = rk.advance(spec, state, graph, trace,
                         torch.tensor(0.3, device=device), rule, rewards, 3,
                         2048, shape)
        assert bits_equal(graph.weights, w0)
        for k, x in tr0.items():
            assert bits_equal(trace[k], x)
        outs.append(out)
    assert bits_equal(outs[0][1].cpu(), outs[1][1])

"""The persistent network kernel's schedule (``csrc/network_persistent.cu``)
on the CPU: a plain PyTorch loop that replays its order against the plain
twin `network_kernels.network_steps_reference`, bit for bit; the route
between the persistent and the per-step design; and the residency plan.

The persistent kernel runs a call as one phase per step: step k-1's edge
passes (STDP, the R-STDP double visit, the connections' visits, with step
k-1's dopamine) fused into step k's cell phase, then the trains' step k;
after the last step an edge-only phase.  In one phase the edge passes read
the lattices' step k-1 spike flags while the cell phase writes step k's,
and the trains' firing times from before their step k-1 while phase A
reads those after it and the train step writes step k's: so spike flags
are double-buffered and the trains' firing times kept in three sets.  The
twin runs each step's phases in the TPU kernel's order, and is held
against the JAX package in ``tests/test_torch_network_kernel.py`` and
``tests/test_torch_reward_net_kernel.py``; so this ties the persistent
order to the JAX package before a card sees it.  On a card, the kernel
against the twin: the ``cuda``-marked tests of those two files.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spiking_neural_networks_tpu as snn

from spiking_neural_networks_tpu_torch.core import structured as tsr
from spiking_neural_networks_tpu_torch.core.plasticity import (
    kernel_exp, rstdp_visit, rule_tensors, stdp_delta)
from spiking_neural_networks_tpu_torch.core.reward_structured import (
    resolve_reward_plan)
from spiking_neural_networks_tpu_torch.models.base import NEVER
from spiking_neural_networks_tpu_torch.ops import network_kernels as nk
from spiking_neural_networks_tpu_torch.ops.kinetics import nt_release
from spiking_neural_networks_tpu_torch.ops.reward_kernels import (
    model_step, shifted)
from torch_networks import (assert_networks_match,
                            assert_reward_networks_match, both,
                            both_reward, chem_net, mixed_net, reward_net)

torch.set_num_threads(1)


# -- the replay ---------------------------------------------------------------


def fused_replay(spec, lats, trains, conns, uniforms, rule, clock0, n_steps,
                 reward=None):
    """The persistent kernel's order on whole planes: phase k runs step
    k-1's edge passes from double-buffered spike flags, the lattices'
    post-step k-1 firing times and the trains' firing times from before
    their step k-1 (the set of step k-2), then step k's cell phase from
    the weights those passes left and the trains' firing times after their
    step k-1, then the trains' step k into set k % 3; phase n is edge-only.
    The dopamine of every step is taken first.  The chemical order: the
    cells of step k gather the concentrations of step k-1 (two parity
    sets, the lattices' and the trains'), update their gating state and
    modifiers in place (only their owner reads them), release from their
    own step k-1 spike flag into set k % 2, and a train releases after its
    step k spike into its set k % 2.  Flat mode: a dense graph's or
    block's sums of step k, from the sources' step k-1 v, effects and
    concentrations, are taken in the cell phase of step k (a tile's jobs,
    then its cells), and the column sums and counts once before the
    first phase.  Returns the twin's layout."""
    p = rule_tensors(rule, "cpu")
    rp = rule_tensors(reward["rule"], "cpu") if reward is not None else None
    dops = []
    if reward is not None and spec.with_reward:
        d = reward["dopamine"]
        for r in reward["rewards"]:
            d = d * rp["exp_dd"] + rp["tau_d"] * torch.tensor(
                float(np.float32(r)))
            dops.append(d)
    cnts = nk.connection_counts(spec, lats, conns)
    weights = [list(d["weights"].unbind(0)) if ls.offsets else []
               for ls, d in zip(spec.lattices, lats)]
    masks = [list(d["mask"].unbind(0)) if ls.offsets else []
             for ls, d in zip(spec.lattices, lats)]
    traces = [{k: list(v.unbind(0)) for k, v in d["traces"].items()}
              if ls.kind == "mod" and ls.offsets else None
              for ls, d in zip(spec.lattices, lats)]
    cw = [list(c["w"].unbind(0)) if cs.op[0] == "resample" else c["w"]
          for cs, c in zip(spec.conns, conns)]
    ctr = [{k: list(c[k].unbind(0)) if cs.op[0] == "resample" else c[k]
            for k in ("c", "dw", "counter")} if cs.reward else None
           for cs, c in zip(spec.conns, conns)]
    chem = bool(spec.chem)
    statics = [nk._chem_static(spec, d, ls.shape) if chem else None
               for ls, d in zip(spec.lattices, lats)]
    # what only a cell's owner reads, updated in place: r, r2, modifiers
    own = [nk._chem_state(spec, d, ls.shape) if chem else None
           for ls, d in zip(spec.lattices, lats)]
    tr_static = [dict(
        ntm=nk._types(d["chem"]["nt$mask"], ts.shape),
        ntm_f=[m.to(torch.float32)
               for m in nk._types(d["chem"]["nt$mask"], ts.shape)],
        ntp=[nk._types(d["chem"][k], ts.shape)
             for k in nk.NT_PARAM_KEYS[ts.nt]])
        if ts.nt else None for ts, d in zip(spec.trains, trains)]
    consts = {k: torch.tensor(float(k)) for k in ("3.57", "3.75")}
    # the call's constants: column sums and per-type counts
    dense = nk._dense_static(spec, lats, conns, statics, tr_static)
    n_lat = len(spec.lattices)
    sets = [[None] * n_lat, [None] * n_lat]     # lattice state by parity
    spk = [[None] * n_lat, [None] * n_lat]      # spike flags by parity
    ntt = [[None] * n_lat, [None] * n_lat]      # concentrations by parity
    tr_ntt = [[None] * len(spec.trains), [None] * len(spec.trains)]
    lft_sets = [[None] * len(spec.trains) for _ in range(3)]
    steps = [d.get("step") for d in trains]
    v_pre = [[] for _ in spec.lattices]

    def lat_state(s, i):
        if s < 0:
            d = lats[i]
            return dict(v=d["v"], w=d["w"], lft=d["lft"], refr=d.get("refr"))
        return sets[s % 2][i]

    def train_lft(s, j):
        return trains[j]["lft"] if s < 0 else lft_sets[s % 3][j]

    def lat_ntt(s, i):
        return own[i]["ntt"] if s < 0 else ntt[s % 2][i]

    def train_ntt(s, j):
        if not spec.trains[j].nt:
            return None
        return nk._types(trains[j]["chem"]["nt$t"], spec.trains[j].shape) \
            if s < 0 else tr_ntt[s % 2][j]

    def spikes(s, i):
        return lats[i]["spikes"] if s < 0 else spk[s % 2][i]

    for k in range(n_steps + 1):
        if k > 0:
            sp = k - 1
            dop = None if reward is None else (
                dops[sp] if spec.with_reward else reward["dopamine"])
            st = [dict(lft=lat_state(sp, i)["lft"], spikes=spk[sp % 2][i])
                  for i in range(n_lat)]
            tr = [dict(lft=train_lft(sp - 1, j))
                  for j in range(len(spec.trains))]
            for i, (ls, d) in enumerate(zip(spec.lattices, lats)):
                if ls.kind == "plain" or not ls.offsets:
                    continue
                lft = st[i]["lft"]
                spk_f = st[i]["spikes"].to(torch.float32)
                lft_pre = shifted(lft, ls.offsets, NEVER)
                spk_pre = shifted(spk_f, ls.offsets, 0.0)
                for o in range(len(ls.offsets)):
                    m = d["mask"][o]
                    if ls.kind == "plastic":
                        delta = stdp_delta(lft_pre[o], lft, p, kernel_exp)
                        weights[i][o] = torch.where(
                            m, weights[i][o] + delta * (spk_pre[o] + spk_f),
                            weights[i][o])
                        continue
                    delta = stdp_delta(lft_pre[o], lft, rp, kernel_exp)
                    trc = traces[i]
                    w1, c1, d1, t1 = rstdp_visit(
                        weights[i][o], trc["c"][o], trc["dw"][o],
                        trc["counter"][o], delta, dop, rp)
                    w2, c2, d2, t2 = rstdp_visit(w1, c1, d1, t1, delta, dop,
                                                 rp)
                    weights[i][o] = torch.where(m, w2, weights[i][o])
                    for key, new in (("c", c2), ("dw", d2), ("counter", t2)):
                        trc[key][o] = torch.where(m, new, trc[key][o])
            for ci, cs in enumerate(spec.conns):
                if cs.updates:
                    nk._conn_visits(cs, conns[ci]["mask"], cw, ci, st, tr,
                                    rp if cs.reward else p,
                                    ctr if cs.reward else None,
                                    dop if cs.reward else None)
        if k == n_steps:
            break
        clock = int(clock0) + k
        effects = [nk.train_effect(ts, d, train_lft(k - 1, j), clock)
                   for j, (ts, d) in enumerate(zip(spec.trains, trains))]
        v_prev = [lat_state(k - 1, i)["v"] for i in range(n_lat)]
        ntt_prev = [lat_ntt(k - 1, i) if chem else None
                    for i in range(n_lat)]
        tr_view = [dict(ntt=train_ntt(k - 1, j))
                   for j in range(len(spec.trains))]
        # flat mode: each tile's dense jobs of step k, then its cells
        dsums = nk._dense_sums(spec, dense, v_prev, effects, ntt_prev,
                               statics, tr_view, tr_static)
        for i, (ls, d) in enumerate(zip(spec.lattices, lats)):
            s = lat_state(k - 1, i)
            pp = {q: d["params"][q] for q in nk.MODEL_PARAM_KEYS[ls.model]}
            cell = dict(v=s["v"], weights=weights[i], mask=masks[i])
            i_syn = torch.zeros_like(s["v"])
            if spec.electrical:
                total = nk._electrical_total(spec, i, ls, cell, d, v_prev,
                                             effects, conns, cw, dense, dsums)
                i_syn = pp["gap_conductance"] * total / cnts[i]
            rec_dv = None
            if chem:
                t_in, valid = nk._chem_input(spec, i, ls, cell, statics[i],
                                             ntt_prev, statics, tr_view,
                                             tr_static, conns, cw, dense,
                                             dsums)
                rec_dv = nk._receptors(spec, statics[i], own[i], s["v"],
                                       t_in, valid, pp, consts)
            v_new, w_new, refr, fired, vp = model_step(
                ls.model, pp, s["v"], s["w"], s["refr"], i_syn, rec_dv)
            if chem:
                # the release from v_pre and the cell's own step k-1 flag
                prev = spikes(k - 1, i).to(torch.float32)
                ntt[k % 2][i] = [torch.where(
                    statics[i]["ntm"][q], nt_release(
                        spec.chem[2], ntt_prev[i][q], vp, prev,
                        [x[q] for x in statics[i]["ntp"]], pp["dt"]), 0.0)
                    for q in range(nk.N_TYPES)]
            sets[k % 2][i] = dict(v=v_new, w=w_new,
                                  lft=s["lft"].masked_fill(fired, clock),
                                  refr=refr)
            spk[k % 2][i] = fired
            v_pre[i].append(vp)
        for j, (ts, d, u) in enumerate(zip(spec.trains, trains, uniforms)):
            if ts.kind == "poisson":
                fired = u[k] <= d["chance"]
            else:
                stepped = steps[j] + d["dt"]
                fired = torch.logical_and(d["rate"] != 0.0,
                                          stepped >= d["rate"])
                steps[j] = torch.where(fired, 0.0, stepped)
            lft_sets[k % 3][j] = train_lft(k - 1, j).masked_fill(fired,
                                                                  clock)
            if ts.nt:
                v_t = torch.where(fired, d["v_th"], d["v_resting"])
                ss = tr_static[j]
                tr_ntt[k % 2][j] = [torch.where(ss["ntm"][q], nt_release(
                    ts.nt, train_ntt(k - 1, j)[q], v_t,
                    fired.to(torch.float32), [x[q] for x in ss["ntp"]],
                    d["dt"]), 0.0) for q in range(nk.N_TYPES)]
            if k == n_steps - 1:
                trains[j] = dict(trains[j], last_spikes=fired)
    last = n_steps - 1
    lat_out = [dict(v=sets[last % 2][i]["v"], w=sets[last % 2][i]["w"],
                    lft=sets[last % 2][i]["lft"],
                    refr=sets[last % 2][i]["refr"], spikes=spk[last % 2][i],
                    weights=torch.stack(weights[i]) if ls.offsets
                    else lats[i]["weights"],
                    v_pre=torch.stack(v_pre[i]) if ls.emit else None,
                    traces=None if traces[i] is None else {
                        k: torch.stack(v) for k, v in traces[i].items()},
                    chem=nk._chem_out(spec, None if not chem else dict(
                        own[i], ntt=ntt[last % 2][i])))
               for i, ls in enumerate(spec.lattices)]
    tr_out = [dict(lft=lft_sets[last % 3][j], step=steps[j],
                   spikes=trains[j].pop("last_spikes"),
                   ntt=nk._stack_types(tr_ntt[last % 2][j]) if ts.nt
                   else None)
              for j, ts in enumerate(spec.trains)]
    conn_out = [torch.stack(w) if cs.op[0] == "resample" else w
                for cs, w in zip(spec.conns, cw)]
    if reward is None:
        return lat_out, tr_out, conn_out, None
    return lat_out, tr_out, conn_out, dict(
        traces=[None if t is None else {
            k: torch.stack(v) if cs.op[0] == "resample" else v
            for k, v in t.items()} for cs, t in zip(spec.conns, ctr)],
        dopamine=dops[-1] if spec.with_reward else reward["dopamine"])


def _pairs(out):
    lat, tr, cn, extra = out
    pairs = []
    for k, d in enumerate(lat):
        for key in ("v", "w", "lft", "refr", "spikes", "weights", "v_pre"):
            if d[key] is not None:
                pairs.append((f"{key}{k}", d[key]))
        if d["traces"] is not None:
            pairs += [(f"{key}{k}", v) for key, v in d["traces"].items()]
        if d["chem"] is not None:
            pairs += [(f"{key}{k}", v) for key, v in sorted(d["chem"].items())]
    for j, d in enumerate(tr):
        pairs += [(f"train {key}{j}", d[key])
                  for key in ("lft", "step", "spikes", "ntt")
                  if d[key] is not None]
    pairs += [(f"conn{c}", w) for c, w in enumerate(cn)]
    if extra is not None:
        for c, t in enumerate(extra["traces"]):
            if t is not None:
                pairs += [(f"conn{c} {key}", v) for key, v in t.items()]
        pairs.append(("dopamine", torch.as_tensor(extra["dopamine"])))
    return pairs


def assert_bit_equal(got, want):
    g, w = _pairs(got), _pairs(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (name, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == torch.float32:   # the bits: +0 and -0 apart
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name


def _advance(out, lats, trains, conns, reward):
    """The next call's inputs from a call's outputs."""
    lat, tr, cn, extra = out
    lats = [dict(d, v=o["v"], w=o["w"], lft=o["lft"], refr=o["refr"],
                 weights=o["weights"], spikes=o["spikes"],
                 **({"traces": o["traces"]} if o["traces"] is not None
                    else {}),
                 **({"chem": {**d["chem"], **o["chem"]}}
                    if o["chem"] is not None else {}))
            for d, o in zip(lats, lat)]
    trains = [dict(d, lft=o["lft"], **({"step": o["step"]}
                                       if o["step"] is not None else {}),
                   **({"chem": {**d["chem"], "nt$t": o["ntt"]}}
                      if o["ntt"] is not None else {}))
              for d, o in zip(trains, tr)]
    conns = [dict(d, w=w, **(t or {}))
             for d, w, t in zip(conns, cn, extra["traces"] if extra
                                else [None] * len(cn))]
    if reward is not None:
        reward = dict(reward, dopamine=torch.as_tensor(extra["dopamine"]))
    return lats, trains, conns, reward


def _grid_inputs(train):
    """Config 5's topology at 16^2 / 8^2 in a firing form: a plastic
    Izhikevich grid, a half-size grid joined by pooling and upsampling,
    a train into the first one to one."""
    _, t = both(lambda: mixed_net(train, rows=16, cols=16,
                                  v0=(-60.0, 50.0)), False, True)
    plan = tsr.resolve_structured_plan(t)
    spec = nk.plain_network_spec(t, plan, not any(tsr.nt_flags(t, plan)))
    return spec, *nk.member_inputs(spec, t, plan), t._plasticity().params


@pytest.mark.parametrize("train", ["poisson", "rate"])
def test_replay_equals_twin_on_config5_topology(train):
    """37 steps as calls of 16, 16 and 5, each call's replay against the
    twin on the state the call received."""
    spec, lats, trains, conns, rule = _grid_inputs(train)
    assert nk.uses_persistent(spec)
    g = torch.Generator().manual_seed(7)
    clock, fired, moved = 3, 0, 0.0
    for n in (16, 16, 5):
        uniforms = [torch.rand((n, *ts.shape), generator=g)
                    if ts.kind == "poisson" else None for ts in spec.trains]
        want = nk.network_steps_reference(spec, lats, trains, conns,
                                          uniforms, rule, clock, n)
        got = fused_replay(spec, [dict(d) for d in lats],
                           [dict(d) for d in trains], conns, uniforms, rule,
                           clock, n)
        assert_bit_equal(got, want)
        fired += sum(int((d["lft"] >= clock).sum()) for d in want[0])
        moved = max(moved, max((w - c["w"]).abs().max().item()
                               for w, c in zip(want[2], conns)))
        lats, trains, conns, _ = _advance(want, lats, trains, conns, None)
        clock += n
    assert fired > 0 and moved > 0


def _reward_inputs(n_steps, seed=4):
    """`bench.py`'s reward network at 16^2 (a reward lattice, a plastic
    lattice, a Poisson train, a plain and a reward connection), v uniform
    across the threshold in both lattices, past firing times, random
    traces, and a schedule of rewards."""
    _, t = both_reward(lambda: reward_net("poisson", seed=5, n_side=16),
                       False, True)
    plan = resolve_reward_plan(t)
    spec = nk.reward_network_spec(t, plan, ("mod", "plastic"), True, True)
    lats, trains, conns = nk.member_inputs(spec, t, plan)
    rng = np.random.default_rng(seed)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    for d in lats:
        shp = tuple(d["v"].shape)
        d["v"] = f32(rng.uniform(-70.0, 35.0, shp))
        d["lft"] = torch.as_tensor(np.where(
            rng.random(shp) < 0.3, rng.integers(0, 3, shp), -1)
            .astype(np.int32))
        if "traces" in d:
            wshape = tuple(d["weights"].shape)
            d["traces"] = dict(
                c=f32(rng.normal(0.0, 0.5, wshape)),
                dw=f32(rng.normal(0.0, 0.5, wshape)),
                counter=torch.as_tensor(rng.integers(0, 2, wshape)
                                        .astype(np.int32)))
    rule = dict(t.reward_modulator.params, tau_d=2.0, tau_c=0.5,
                a_plus=0.02, a_minus=0.02)
    reward = dict(rule=rule, dopamine=torch.tensor(0.25),
                  rewards=np.where(np.arange(n_steps) % 5 < 3, 0.4, -0.3)
                  .astype(np.float32))
    return spec, lats, trains, conns, t._plasticity().params, reward


def test_replay_equals_twin_on_the_reward_network():
    """Calls of 16 and 7 steps with a reward schedule, traces and
    dopamine included."""
    spec, lats, trains, conns, rule, reward = _reward_inputs(23)
    assert nk.uses_persistent(spec) and nk.is_reward(spec)
    schedule = reward["rewards"]
    g = torch.Generator().manual_seed(9)
    clock, done = 3, 0
    traces0 = lats[0]["traces"]["c"].clone()
    for n in (16, 7):
        uniforms = [torch.rand((n, *ts.shape), generator=g)
                    for ts in spec.trains]
        call_reward = dict(reward, rewards=schedule[done:done + n])
        want = nk.network_steps_reference(spec, lats, trains, conns,
                                          uniforms, rule, clock, n,
                                          call_reward)
        got = fused_replay(spec, [dict(d) for d in lats],
                           [dict(d) for d in trains], conns, uniforms, rule,
                           clock, n, call_reward)
        assert_bit_equal(got, want)
        lats, trains, conns, reward = _advance(want, lats, trains, conns,
                                               call_reward)
        clock, done = clock + n, done + n
    assert not torch.equal(lats[0]["traces"]["c"], traces0)
    assert bool((lats[0]["lft"] >= 3).any())


# -- route and residency plan -------------------------------------------------


def test_chemical_and_flat_specs_keep_the_per_step_path():
    """Past the persistent kernel's limits a chemical or a flat spec keeps
    the per-step launches: a chemical spec of more lattices than the
    kernel's description holds, and a flat spec of more 32-neuron lattice
    tiles than the card has blocks (a block holds one tile's dense
    columns).  Within them both take the persistent kernel."""
    spec = _grid_inputs("rate")[0]
    assert nk.uses_persistent(spec)
    assert nk.uses_persistent(_reward_inputs(4)[0])
    _, t = both(lambda: chem_net(), False, True)
    plan = tsr.resolve_structured_plan(t)
    chem = nk.plain_network_spec(t, plan, not any(tsr.nt_flags(t, plan)),
                                 tsr.nt_flags(t, plan))
    assert chem is not None and chem.chem
    assert nk.uses_persistent(chem)
    assert not nk.uses_persistent(chem._replace(
        lattices=chem.lattices * 5))
    flat = spec._replace(lattices=tuple(
        ls._replace(graph="dense", offsets=(), shape=(1, 512))
        for ls in spec.lattices))
    assert nk.is_flat(flat) and nk.uses_persistent(flat, 132)
    assert not nk.uses_persistent(flat, 31)


def test_a_spec_beyond_the_kernels_members_takes_the_per_step_path():
    """A grid-mode spec of more members than the persistent kernel's
    description holds is not refused: `uses_persistent` sends it to the
    per-step launches (the twin on the CPU)."""
    spec, lats, trains, conns, rule = _grid_inputs("rate")
    n = nk.NP_MAX_TR + 1
    big = spec._replace(trains=spec.trains * n)
    assert not nk.uses_persistent(big) and not nk.is_flat(big)
    args = (lats, trains * n, conns, [None] * n, rule, 3, 2)
    assert_bit_equal(nk.network_steps(big, *args),
                     nk.network_steps_reference(big, *args))


def _chain_net(reward):
    """One more lattice than the persistent kernel takes: `mixed_net`'s
    grids at 4 x 4 (or `reward_net`'s two lattices at 8 x 8), then
    Izhikevich lattices of that side up to nine, each driven one to one
    by the one before."""
    side = 8 if reward else 4
    net = reward_net("rate", seed=5) if reward \
        else mixed_net("rate", rows=side, cols=side, v0=(-60.0, 50.0))
    rng = np.random.default_rng(3)
    prev = 1 if reward else 0
    for lid in range(3, 3 + nk.NP_MAX_LAT - 1):
        lat = snn.Lattice(snn.Izhikevich(), id=lid)
        lat.populate(side, side, gap_conductance=10.0)
        lat.connect_stencil(radius=1.5, seed=lid)
        lat.apply(lambda s: {**s, "v": jnp.asarray(
            rng.uniform(-60.0, 50.0, side * side), jnp.float32)})
        net.add_lattice(lat)
        net.connect(prev, lid, lambda a, b: a == b, lambda a, b: 8.0)
        prev = lid
    return net


@pytest.mark.parametrize("reward", [False, True])
def test_a_nine_lattice_network_keeps_a_kernel_route(reward):
    """Nine lattices: the network keeps the network kernels' route (the
    per-step launches on a card, the twin here) and matches the JAX
    package's fused kernel."""
    if reward:
        j, t = both_reward(lambda: _chain_net(True), True, True)
        j.run_lattices_with_reward(0.5, 20)
        t.run_lattices_with_reward(0.5, 20)
        spec = nk.reward_network_spec(t, resolve_reward_plan(t),
                                      ("mod",) + ("plastic",)
                                      + ("plain",) * 7, True, True)
        assert t._last_run_fused == ("reward", False)
        assert_reward_networks_match(t, j, 1e-5, 1e-4)
    else:
        j, t = both(lambda: _chain_net(False), True, True)
        j.run_lattices(20)
        t.run_lattices(20)
        plan = tsr.resolve_structured_plan(t)
        spec = nk.plain_network_spec(t, plan,
                                     not any(tsr.nt_flags(t, plan)))
        assert t._last_run_fused == ("network", False)
        assert_networks_match(t, j, 1e-6, 1e-5)
    assert j._last_run_fused
    assert len(spec.lattices) == nk.NP_MAX_LAT + 1
    assert not nk.uses_persistent(spec)
    assert sum(int((lat.state["last_firing_time"] >= 0).sum())
               for lat in list(t.lattices.values())[2:]) > 0


def _scaled(spec, side):
    """``spec`` with every lattice and train at ``side`` (or its half,
    where the spec's lattice is half the first's) and its resample ops
    scaled to match."""
    base = spec.lattices[0].shape[0]

    def shp(s):
        return (s[0] * side // base, s[1] * side // base)

    def op(cs):
        if cs.op[0] != "resample":
            return cs.op
        _, r1, c1, r2, c2, fr, fc, taps = cs.op
        return ("resample", *shp((r1, c1)), *shp((r2, c2)), fr, fc, taps)

    return spec._replace(
        lattices=tuple(ls._replace(shape=shp(ls.shape))
                       for ls in spec.lattices),
        trains=tuple(ts._replace(shape=shp(ts.shape))
                     for ts in spec.trains),
        conns=tuple(cs._replace(op=op(cs)) for cs in spec.conns))


def _resident_bytes(members):
    return sum(m.cell_bytes * m.cells for m in members if m.resident)


def test_plan_keeps_all_of_config5_resident_at_512():
    spec = _scaled(_grid_inputs("poisson")[0], 512)
    assert spec.lattices[0].shape == (512, 512)
    assert spec.lattices[1].shape == (256, 256)
    members, smem = nk.persistent_plan(spec, 132)
    assert [m.key for m in members] == [("lat", 0), ("lat", 1), ("conn", 0),
                                        ("conn", 1), ("conn", 2)]
    assert all(m.resident for m in members)
    # 12-offset plastic stencil 15.7 MB, the plain 8-offset one 2.1 MB
    # (no mask: its steps never read it), three connections 3.9 MB
    assert _resident_bytes(members) == (
        12 * 5 * 512 ** 2 + 8 * 4 * 256 ** 2 + 5 * 512 ** 2
        + 4 * 5 * 256 ** 2 + 5 * 512 ** 2)
    assert 0 < smem <= nk.SMEM_BUDGET
    offsets = [m.offset for m in members]
    assert offsets == sorted(offsets) and all(o % 16 == 0 for o in offsets)


def test_plan_streams_what_does_not_fit():
    """The 512^2 reward network streams its mod lattice (17 bytes a slot:
    weight, traces, mask) and keeps its other members, in spec order;
    config 5 at 1024^2 / 512^2 streams its excitatory stencil only."""
    reward = _scaled(_reward_inputs(4)[0], 512)
    members, smem = nk.persistent_plan(reward, 132)
    assert [m.key for m in members] == [("lat", 0), ("lat", 1), ("conn", 0),
                                        ("conn", 1)]
    assert [m.resident for m in members] == [False, True, True, True]
    assert members[0].cell_bytes == 12 * 17
    assert 0 < smem <= nk.SMEM_BUDGET
    big = _scaled(_grid_inputs("poisson")[0], 1024)
    members, smem = nk.persistent_plan(big, 132)
    assert [m.resident for m in members] == [False, True, True, True, True]
    assert sum(m.cell_bytes * m.cells for m in members) > 85e6
    assert smem <= nk.SMEM_BUDGET


@pytest.mark.parametrize("side,budget", [(16, nk.SMEM_BUDGET), (512, 0),
                                         (4096, nk.SMEM_BUDGET),
                                         (512, 40000)])
def test_plan_refuses_nothing(side, budget):
    """Every spec gets a plan: every member an entry, the resident ones
    within the budget and apart, the rest streamed."""
    for spec in (_scaled(_grid_inputs("poisson")[0], side),
                 _scaled(_reward_inputs(4)[0], side)):
        members, smem = nk.persistent_plan(spec, 132, budget)
        assert len(members) == len(nk._member_layout(spec))
        assert smem <= budget
        ends = []
        for m in members:
            share = -(-m.cap * 32 * m.cell_bytes // 16) * 16
            assert m.cap * 132 * 32 >= m.cells
            if m.resident:
                ends.append((m.offset, m.offset + share))
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
        assert all(e <= smem for _, e in ends)

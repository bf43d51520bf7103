"""The persistent network kernel's chemical and flat-mode orders
(``csrc/network_persistent.cu``, the chemical and flat instantiations) on
the CPU: `fused_replay` (``tests/test_torch_persistent_schedule.py``)
replays them on whole planes against the plain twin
`network_kernels.network_steps_reference`, bit for bit, and, as the port's
kernel route, against the JAX package's XLA path; the residency plan of
chemical and flat members; the route.

In one phase a chemical cell gathers its neighbours' step k-1
concentrations while they write step k's, releases from its own step k-1
spike flag, and a train's release of step k writes its concentrations
while the cells of step k read its step k-1 ones: so concentrations and
spike flags are kept in two parity sets, the trains' concentrations too.
In flat mode the block that owns a 32-neuron tile takes every dense job
into the tile and then the tile's cells in one phase.  On a card, the
kernel against the twin: the ``cuda``-marked tests of
``tests/test_torch_chem_kernel.py`` and ``tests/test_torch_flat_kernel.py``.

Tolerance against the JAX package: rtol 1e-5, atol 1e-4 with firing times
and spikes equal, as ``tests/test_torch_chem_network.py`` states it (the
currents are ~1e3, and the twin's exp and pow are within an ulp or a few
of XLA's).
"""

import os
import sys

import numpy as np
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu_torch.convert import network_from
from spiking_neural_networks_tpu_torch.core import structured as tsr
from spiking_neural_networks_tpu_torch.ops import network_kernels as nk
from test_torch_chem_network import RTOL, ATOL, assert_chem_networks_match
from test_torch_flat_kernel import firing_dense_net
from test_torch_flat_network import bayes_pair
from test_torch_persistent_schedule import (_advance, assert_bit_equal,
                                            fused_replay)
from torch_networks import both, chem_net

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (the card's builders of the main paths)

CALLS = (16, 7, 37)


def _inputs(net):
    plan = tsr.resolve_structured_plan(net)
    flags = tsr.nt_flags(net, plan)
    n_lat = len(plan["lat_ids"])
    spec = nk.plain_network_spec(net, plan, not any(flags), flags[n_lat:])
    assert spec is not None
    return (spec, *nk.member_inputs(spec, net, plan),
            net._plasticity().params)


def _firing_state(spec, lats, trains, seed):
    """A random state across the threshold, as the card's random cases
    draw it: v in [-70, 40), 30% of the neurons with a past firing time
    and a spike flag, concentrations and gating values in [0, 1), 80% of
    the receptor and transmitter slots inserted, modifiers in [0.5, 1)."""
    rng = np.random.default_rng(seed)

    def f(lo, hi, shp):
        return torch.as_tensor(rng.uniform(lo, hi, shp).astype(np.float32))

    def b(p, shp):
        return torch.as_tensor(rng.random(shp) < p)

    for ls, d in zip(spec.lattices, lats):
        shp = ls.shape
        d["v"] = f(-70, 40, shp)
        d["lft"] = torch.as_tensor(np.where(
            rng.random(shp) < 0.3, rng.integers(0, 3, shp),
            -1).astype(np.int32))
        d["spikes"] = b(0.3, shp)
        c = dict(d["chem"])
        n = c["nt$t"].shape[0]
        c.update({"nt$t": f(0, 1, (n, 3)), "rec$r": f(0, 1, (n, 3)),
                  "nt$mask": b(0.8, (n, 3)), "rec$mask": b(0.8, (n, 3))})
        if "rec$r2" in c:
            c.update({"rec$r2": f(0, 1, (n, 3)),
                      "rec$nmda_modifier": f(0.5, 1, (n,)),
                      "rec$inh_modifier": f(0.5, 1, (n,)),
                      "rec$s_d1": f(0.05, 0.2, (n,)),
                      "rec$s_d2": f(0.05, 0.2, (n,))})
        d["chem"] = c
    for ts, d in zip(spec.trains, trains):
        if ts.nt:
            d["chem"] = dict(d["chem"], **{"nt$t": f(0, 1, (
                d["chem"]["nt$t"].shape[0], 3))})
    return lats, trains


def _replay_calls(spec, lats, trains, conns, rule, seed=3):
    """Calls of 16, 7 and 37 steps (three launches of the kernel), each
    replayed against the twin on the state the call received; returns the
    neurons fired and whether a concentration moved."""
    g = torch.Generator().manual_seed(seed)
    clock, fired, moved = 3, 0, False
    for n in CALLS:
        uniforms = [torch.rand((n, *ts.shape), generator=g)
                    if ts.kind == "poisson" else None for ts in spec.trains]
        want = nk.network_steps_reference(spec, lats, trains, conns,
                                          uniforms, rule, clock, n)
        got = fused_replay(spec, [dict(d) for d in lats],
                           [dict(d) for d in trains], conns, uniforms, rule,
                           clock, n)
        assert_bit_equal(got, want)
        fired += sum(int((d["lft"] >= clock).sum()) for d in want[0])
        moved |= any(not torch.equal(o["chem"]["nt$t"], d["chem"]["nt$t"])
                     for o, d in zip(want[0], lats) if o["chem"])
        lats, trains, conns, _ = _advance(want, lats, trains, conns, None)
        clock += n
    return fired, moved


CHEM_CASES = [
    ("ionotropic", "approximate", "approximate", False, False, False),
    ("ionotropic", "destexhe", "destexhe", True, True, False),
    ("dopaglugaba", "bounded", "bounded", False, False, True),
    ("dopaglugaba", "exponential_decay", "exponential_decay", True, True,
     False),
]


@pytest.mark.parametrize("fam,rec,nt,plastic,electrical,dopamine",
                         CHEM_CASES)
def test_replay_equals_twin_on_a_chemical_network(fam, rec, nt, plastic,
                                                  electrical, dopamine):
    """2 x 12^2 lattices (a third lattice releasing dopamine in the
    dopamine form) and a Poisson train releasing its neurotransmitter,
    with and without STDP and electrical synapses, from a firing state."""
    train = snn.PoissonSpikeTrain(nt_kinetics=nt)
    _, t = both(lambda: chem_net(fam, rec, nt, dopamine=dopamine, rows=12,
                                 cols=12, train=train, plastic=plastic,
                                 electrical=electrical), False, True)
    spec, lats, trains, conns, rule = _inputs(t)
    assert spec.chem and not nk.is_flat(spec) and nk.uses_persistent(spec)
    assert spec.trains[0].nt == nt
    lats, trains = _firing_state(spec, lats, trains, seed=len(rec))
    fired, moved = _replay_calls(spec, lats, trains, conns, rule)
    assert fired > 0 and moved


def _bayes48():
    """The Bayesian network of the card's main path at 48 + 48 neurons
    (a narrower random block would be classified as a resample), its cues
    firing at 200 and 100 Hz."""
    return chip_smoke.bayes_net(snt, (6, 8), (6, 8), device="cpu",
                                hertz=(200.0, 100.0))


@pytest.mark.parametrize("build", [
    _bayes48, lambda: network_from(firing_dense_net(False, n=48), "cpu"),
    lambda: network_from(firing_dense_net(True, n=48), "cpu")],
    ids=["bayesian-48+48", "electrical-dense-2x48", "chemical-dense-2x48"])
def test_replay_equals_twin_in_flat_mode(build):
    spec, lats, trains, conns, rule = _inputs(build())
    assert nk.is_flat(spec) and nk.uses_persistent(spec)
    fired, moved = _replay_calls(spec, lats, trains, conns, rule)
    assert fired > 0 and (moved or not spec.chem)


@pytest.mark.parametrize("name", ["stdp-electrical", "dopamine",
                                  "bayesian"])
def test_replayed_route_matches_jax_xla(monkeypatch, name):
    """The port's kernel route on the CPU with the replay in the twin's
    place, 37 steps in calls of 16, 16 and 5, against the JAX package's
    XLA path: the chemical network's dopamine form (its third lattice
    fires from the start) with STDP and electrical synapses and without,
    and the upstream-size Bayesian network (cues at rate 0, as the JAX
    package's test of it runs)."""
    monkeypatch.setattr(nk, "network_steps_reference", fused_replay)
    if name == "bayesian":
        j, t = bayes_pair(False, True)
    else:
        stdp = name == "stdp-electrical"
        j, t = both(lambda: chem_net("dopaglugaba", "bounded", "bounded",
                                     dopamine=True, plastic=stdp,
                                     electrical=stdp), False, True)
    j.run_lattices(37)
    t.run_lattices(37)
    assert t._last_run_fused[0] in ("chemical", "flat-chemical")
    assert_chem_networks_match(t, j, RTOL, ATOL)
    assert sum(int((lat.state["last_firing_time"] >= 0).sum())
               for lat in t.lattices.values()) > 0


# -- residency plan and route ------------------------------------------------


def _bench_chem_spec(side):
    """`bench.py`'s chemical network (the card's main path) at side^2."""
    net = chip_smoke.chem_net(snt, 8, 8, device="cpu")
    spec = _inputs(net)[0]
    return spec._replace(
        lattices=tuple(ls._replace(shape=(side, side))
                       for ls in spec.lattices),
        trains=tuple(ts._replace(shape=(side, side))
                     for ts in spec.trains))


def _share(m):
    return -(-m.cap * 32 * m.cell_bytes // 16) * 16


def test_plan_keeps_the_64_chemical_network_resident():
    """2 x 64^2: one tile of each lattice a block, every member resident:
    the radius-2 stencils (weight and mask, 5 bytes a slot), the
    DopaGluGABA parameters (21 float planes and the receptor mask's 3
    bytes), the one-to-one connections, the gating state (8 planes)."""
    spec = _bench_chem_spec(64)
    members, smem = nk.persistent_plan(spec, 132)
    assert [m.key for m in members] == [
        ("lat", 0), ("lat", 1), ("chemp", 0), ("chemp", 1), ("conn", 0),
        ("conn", 1), ("chems", 0), ("chems", 1)]
    assert all(m.resident and m.cap == 1 for m in members)
    n_off = len(spec.lattices[0].offsets)
    assert [m.cell_bytes for m in members] == [
        5 * n_off, 5 * len(spec.lattices[1].offsets), 4 * 21 + 3,
        4 * 21 + 3, 5, 5, 32, 32]
    assert nk.chem_param_planes(spec.chem) == 21
    assert smem == sum(_share(m) for m in members) <= nk.SMEM_BUDGET


def test_plan_streams_most_of_the_512_chemical_network():
    """2 x 512^2: 63 tiles of each lattice a block; the first stencil, the
    connections and the first lattice's state fit, the parameters and the
    second stencil stream: most bytes stream."""
    spec = _bench_chem_spec(512)
    members, smem = nk.persistent_plan(spec, 132)
    assert all(m.cap == 63 for m in members)
    res = sum(m.cell_bytes * m.cells for m in members if m.resident)
    streamed = sum(m.cell_bytes * m.cells for m in members
                   if not m.resident)
    assert streamed > 2 * res > 0
    assert not any(m.resident for m in members if m.key[0] == "chemp")
    assert smem <= nk.SMEM_BUDGET


def _bayes_spec(n):
    spec = _inputs(_bayes48())[0]
    return spec._replace(
        lattices=tuple(ls._replace(shape=(1, n)) for ls in spec.lattices),
        trains=tuple(ts._replace(shape=(1, n)) for ts in spec.trains))


def test_plan_keeps_the_512_bayesian_network_resident():
    """512 + 512: each block holds one tile of one lattice, so the plan
    is per lattice: the excitatory tile's dense graph and the block from
    the inhibitory pool (64 KB each), its parameters, cues and state; the
    pool's tile the block from the excitatory lattice; all within the
    budget less flat mode's scratch."""
    spec = _bayes_spec(512)
    members, smem = nk.persistent_plan(spec, 132)
    assert all(m.resident and m.cap == 1 for m in members)
    by_key = {m.key: m for m in members}
    assert by_key["lat", 1].cell_bytes == 4 * 512
    dense = [m for m in members if m.key[0] == "conn"
             and spec.conns[m.key[1]].op[0] == "dense"]
    assert [m.cell_bytes for m in dense] == [4 * 512, 4 * 512]
    groups = {}
    for m in members:
        post = m.key[1] if m.key[0] != "conn" else spec.conns[m.key[1]].post
        groups.setdefault(post, []).append(m)
    for group in groups.values():
        ends = [(m.offset, m.offset + _share(m)) for m in group]
        assert ends[0][0] == 0
        assert all(a[1] == b[0] for a, b in zip(ends, ends[1:]))
    assert smem == max(sum(_share(m) for m in g) for g in groups.values())
    assert 2 * 64 * 1024 < smem <= nk.SMEM_BUDGET - nk.NP_FLAT_SCRATCH


@pytest.mark.parametrize("extra", [0, 4096, 70000])
def test_flat_plan_budget_arithmetic(extra):
    """Flat mode's members fit what the budget leaves after its scratch,
    per lattice tile: going in order, a member is resident where its share
    (cap 1: 32 cells, rounded up to 16 bytes) still fits after the
    resident members before it in its lattice's group."""
    spec = _bayes_spec(512)
    members, smem = nk.persistent_plan(
        spec, 132, nk.NP_FLAT_SCRATCH + extra)
    used = {}
    for m in members:
        post = m.key[1] if m.key[0] != "conn" else spec.conns[m.key[1]].post
        at = used.get(post, 0)
        assert m.resident == (at + _share(m) <= extra)
        assert m.offset == (at if m.resident else 0)
        used[post] = at + (_share(m) if m.resident else 0)
    assert smem == max(used.values()) <= extra
    assert any(m.resident for m in members) == (extra > 0)


def test_routes():
    """A chemical spec whose plan holds every member (2 x 64^2) and a flat
    spec take the persistent kernel; a chemical spec with streamed members
    (2 x 512^2, where the card's run in turns measured the per-step design
    faster), a chemical spec of nine lattices (one past the kernel's
    description) and a flat spec of more tiles than blocks keep the
    per-step launches."""
    chem = _bench_chem_spec(64)
    flat = _bayes_spec(512)
    assert nk.uses_persistent(chem) and nk.uses_persistent(flat)
    big = _bench_chem_spec(512)
    assert not all(m.resident for m in nk.persistent_plan(big, 132)[0])
    assert not nk.uses_persistent(big)
    nine = chem._replace(lattices=chem.lattices * 4 + chem.lattices[:1])
    assert len(nine.lattices) == nk.NP_MAX_LAT + 1
    assert not nk.uses_persistent(nine)
    assert not nk.uses_persistent(flat, n_blocks=31)

"""The port's `LatticeNetwork` on its plain route (``use_kernel=False``)
against the JAX package's XLA structured runner (``use_pallas=False``), on
the same networks built in the JAX package and carried over with
`convert.network_from`; the connection classifier, the per-edge API, the
routing and the errors.

Tolerance: v, w, graph and connection weights within rtol 1e-5, atol 1e-5
(one step: BASELINE's fidelity target of rtol 1e-5), firing times, spikes
and refractory counts equal.  The plain route computes in the XLA path's
association; the backends still round a few operations apart (XLA folds
the train effect's ``-1 / (k / dt)`` into ``-dt / k``), and spiking
dynamics carry an ulp forward, so long runs hold the same rtol, not bit
equality.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.core import structured as jsr
from spiking_neural_networks_tpu.core.history import HISTORY_KINDS
from spiking_neural_networks_tpu_torch.core import structured as tsr
from spiking_neural_networks_tpu_torch.errors import LatticeNetworkError
from torch_networks import (assert_networks_match, both, mixed_net,
                            plain_net)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5
NETS = {"alif": lambda: plain_net("alif"),
        "lif": lambda: plain_net("lif"),
        "izhikevich-exp": lambda: plain_net(
            "izhikevich", refractoriness="exponential_decay"),
        "mixed": lambda: mixed_net(),
        "preset": lambda: _with_preset(plain_net("izhikevich"))}


def _with_preset(net):
    """The network with its train swapped for a Preset train cycling
    through 0.3, 0.5 and 1.1 ms (the plain route's class only)."""
    st = snn.SpikeTrainLattice(snn.PresetSpikeTrain(), id=2)
    st.populate(8, 8, firing_times=[0.3, 0.5, 1.1])
    net.spike_train_lattices[2] = st
    return net


def _refr_equal(t, j):
    for lid, jl in j.lattices.items():
        if "refractory_count" in jl.state:
            np.testing.assert_array_equal(
                t.lattices[lid].state["refractory_count"].numpy(),
                np.asarray(jl.state["refractory_count"]))


@pytest.mark.parametrize("name", sorted(NETS))
def test_plain_route_matches_xla_runner(name):
    """137 steps (the JAX package's own fused-network length): ALIF and
    LIF nets with a Rate train and refractory counts, an Izhikevich net
    with exponential-decay refractoriness, and the mixed 8x8 / 4x4 net
    with pooling and upsampling resample connections."""
    j, t = both(NETS[name], False, False)
    j.run_lattices(137)
    t.run_lattices(137)
    assert t._last_run_fused is False and not j._last_run_fused
    assert_networks_match(t, j, RTOL, ATOL)
    _refr_equal(t, j)
    assert (t.lattices[0].state["last_firing_time"] > 3).any()
    before = both(NETS[name], False, False)[1]
    moved = [np.abs(t.connections[k][2] - before.connections[k][2]).max()
             for k in t.connections]
    assert max(moved) > 1e-2 and np.abs(
        t.lattices[0].graph.weights.numpy()
        - before.lattices[0].graph.weights.numpy()).max() > 1e-2


@pytest.mark.parametrize("name", sorted(NETS))
def test_one_step_matches_xla_runner(name):
    j, t = both(NETS[name], False, False)
    j.run_lattices(1)
    t.update()
    assert_networks_match(t, j, RTOL, 0.0)
    _refr_equal(t, j)


@pytest.mark.parametrize("kind", ["grid", "average", "eeg", "spikes"])
def test_histories_match_xla_runner(kind):
    """A grid history of each kind on the excitatory lattice, 53 steps in
    chunks of 20, with the inhibitory lattice's graph history and the
    train's spike history riding along."""
    def build():
        net = mixed_net(hist=HISTORY_KINDS[kind]())
        net.history_chunk = 20
        net.lattices[1].update_graph_history = True
        st = net.spike_train_lattices[2]
        st.grid_history = HISTORY_KINDS["spikes"]()
        st.update_grid_history = True
        return net

    j, t = both(build, False, False)
    j.run_lattices(53)
    t.run_lattices(53)
    assert_networks_match(t, j, RTOL, ATOL)
    hj = j.lattices[0].grid_history.history
    ht = t.lattices[0].grid_history.history
    assert len(ht) == len(hj) == 53
    if kind == "spikes":
        np.testing.assert_array_equal(np.stack(ht), np.stack(hj))
    else:
        np.testing.assert_allclose(np.asarray(ht), np.asarray(hj), rtol=RTOL,
                                   atol=1e-3)
    np.testing.assert_array_equal(
        np.stack(t.spike_train_lattices[2].grid_history.history),
        np.stack(j.spike_train_lattices[2].grid_history.history))
    gt, gj = t.lattices[1].graph_history, j.lattices[1].graph_history
    assert len(gt) == len(gj) == 53
    np.testing.assert_allclose(np.stack(gt), np.stack(gj), rtol=RTOL,
                               atol=ATOL)


def test_poisson_network_matches_statistically():
    """Different uniform streams: firing fractions over 400 steps."""
    def frac(net):
        net.run_lattices(400)
        lft = np.asarray(net.lattices[0].state["last_firing_time"])
        st = np.asarray(
            net.spike_train_lattices[2].state["last_firing_time"])
        return (lft > 3).mean(), (st >= 0).mean()

    j, t = both(lambda: mixed_net("poisson"), False, False)
    (fj, sj), (ft, sf) = frac(j), frac(t)
    assert abs(fj - ft) <= 0.25 and abs(sj - sf) <= 0.2 and sf > 0.5


def _edges(n_pre, n_post, rule):
    src, dst = [], []
    for i in range(n_pre):
        for j in range(n_post):
            if rule(i, j):
                src.append(i)
                dst.append(j)
    return np.asarray(src, np.int64), np.asarray(dst, np.int64)


@pytest.mark.parametrize("case", ["empty", "one2one", "pool", "upsample",
                                  "shifted", "dense", "padded"])
def test_classify_connection_matches_jax(case):
    rng = np.random.default_rng(3)
    shapes = {"pool": ((8, 8), (4, 4)), "upsample": ((4, 4), (8, 8))}
    pre, post = shapes.get(case, ((6, 6), (6, 6)))
    n_pre, n_post = pre[0] * pre[1], post[0] * post[1]
    if case == "empty":
        src = dst = np.zeros(0, np.int64)
    elif case == "one2one":
        src = dst = np.arange(n_post, dtype=np.int64)[rng.random(n_post)
                                                      < 0.7]
    elif case == "pool":
        src, dst = _edges(n_pre, n_post, lambda i, j: (i // 8) // 2 == j // 4
                          and (i % 8) // 2 == j % 4)
    elif case == "upsample":
        src, dst = _edges(n_pre, n_post, lambda i, j: i // 4 == (j // 8) // 2
                          and i % 4 == (j % 8) // 2)
    elif case == "shifted":
        src, dst = _edges(n_pre, n_post, lambda i, j: i == j + 1 and i % 6)
    elif case == "dense":
        src, dst = _edges(n_pre, n_post,
                          lambda i, j: (i * 7 + j * 3) % 11 == 0)
    if case == "padded":
        # a plastic block above 1M entries with in-degree <= 16
        n_pre = n_post = 1100
        src = rng.integers(0, n_pre, 3000)
        dst = rng.integers(0, n_post, 3000)
        pre = post = None
    w = rng.uniform(-1.0, 1.0, len(src)).astype(np.float32)
    kw = dict(pre_shape=pre, post_shape=post)
    jop = jsr.classify_connection(src, dst, w, n_pre, n_post, True, **kw)
    top = tsr.classify_connection(src, dst, w, n_pre, n_post, True, **kw)
    assert top.kind == jop.kind
    kind = top.kind[0] if isinstance(top.kind, tuple) else top.kind
    assert kind == {"pool": "resample", "upsample": "resample",
                    "shifted": "resample"}.get(case, case)
    np.testing.assert_array_equal(top.w0.numpy(), np.asarray(jop.w0))
    for key, val in jop.aux.items():
        np.testing.assert_array_equal(top.aux[key].numpy(), np.asarray(val),
                                      err_msg=key)
    np.testing.assert_array_equal(top.extract(top.w0),
                                  np.asarray(jop.extract(jop.w0)))
    if case == "one2one":
        np.testing.assert_array_equal(top.extract(top.w0), w)


def test_resample_gather_and_edge_layout_match_jax():
    """`_conn_gather` and `_edge_layout` of pooling and upsampling blocks
    on random planes."""
    rng = np.random.default_rng(4)
    for pre, post, rule in (
            ((8, 8), (4, 4), lambda i, j: (i // 8) // 2 == j // 4
             and (i % 8) // 2 == j % 4),
            ((4, 4), (8, 8), lambda i, j: i // 4 == (j // 8) // 2
             and i % 4 == (j % 8) // 2)):
        n_pre, n_post = pre[0] * pre[1], post[0] * post[1]
        src, dst = _edges(n_pre, n_post, rule)
        w = rng.uniform(-1, 1, len(src)).astype(np.float32)
        jop = jsr.classify_connection(src, dst, w, n_pre, n_post, True,
                                      pre_shape=pre, post_shape=post)
        top = tsr.classify_connection(src, dst, w, n_pre, n_post, True,
                                      pre_shape=pre, post_shape=post)
        a = rng.uniform(-70, 30, n_pre).astype(np.float32)
        sub = np.ones(n_pre, np.float32)
        v = rng.uniform(-70, 30, n_post).astype(np.float32)
        got = tsr._conn_gather(top.kind, top.aux, top.w0, torch.from_numpy(a),
                               torch.from_numpy(sub), torch.from_numpy(v))
        want = jsr._conn_gather(jop.kind, jop.aux, jop.w0, jnp.asarray(a),
                                jnp.asarray(sub), jnp.asarray(v))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-5)
        lft = rng.integers(-1, 50, n_pre).astype(np.int32)
        tp, _ = tsr._edge_layout(top.kind, top.aux,
                                 {"lft": torch.from_numpy(lft)}, {})
        jp, _ = jsr._edge_layout(jop.kind, jop.aux,
                                 {"lft": jnp.asarray(lft)}, {})
        np.testing.assert_array_equal(tp["lft"].numpy(), np.asarray(jp["lft"]))


def test_per_edge_api_matches_jax():
    j, t = both(mixed_net, False, False)
    queries = [((0, (1, 1)), (0, (1, 2))), ((0, (1, 1)), (0, (5, 5))),
               ((2, (3, 3)), (0, (3, 3))), ((2, (3, 3)), (0, (3, 4))),
               ((0, (5, 4)), (1, (2, 2))), ((1, (2, 2)), (0, (5, 4))),
               ((1, (2, 2)), (0, (0, 0)))]
    for pre, post in queries:
        assert t.lookup_weight(pre, post) == j.lookup_weight(pre, post)
    for pos in ((0, (0, 0)), (0, (5, 4)), (1, (2, 2)), (1, (0, 3))):
        assert t.get_incoming_connections(pos) \
            == j.get_incoming_connections(pos)
    edits = [((0, (1, 1)), (0, (1, 2)), 0.25), ((0, (1, 1)), (0, (4, 4)), 2.0),
             ((0, (1, 1)), (0, (1, 2)), None), ((2, (3, 3)), (0, (3, 3)), 7.0),
             ((2, (3, 3)), (0, (3, 4)), 1.5), ((1, (2, 2)), (0, (5, 4)), None)]
    for pre, post, w in edits:
        for net in (j, t):
            net.edit_weight(pre, post, w)
        assert t.lookup_weight(pre, post) == j.lookup_weight(pre, post)
    for pos in ((0, (1, 2)), (0, (3, 4)), (0, (5, 4)), (0, (4, 4))):
        assert t.get_incoming_connections(pos) \
            == j.get_incoming_connections(pos)
    g_t, g_j = t.lattices[0].graph, j.lattices[0].graph
    assert g_t.offsets == g_j.offsets
    np.testing.assert_array_equal(g_t.weights.numpy(), np.asarray(g_j.weights))
    np.testing.assert_array_equal(g_t.in_deg.numpy(), np.asarray(g_j.in_deg))
    # the edited network still runs and matches
    j.run_lattices(12)
    t.run_lattices(12)
    assert_networks_match(t, j, RTOL, ATOL)


def test_edgeless_lattice_and_dt_and_timing_match_jax():
    """A lattice with no intra edges (fed only by a train), `set_dt` and
    `reset_timing` across the members."""
    def build():
        lat = snn.Lattice(snn.AdaptiveLeakyIntegrateAndFire(), id=0)
        lat.populate(5, 6, gap_conductance=10.0)
        lat.apply(lambda s: {**s, "v": jnp.asarray(np.random.default_rng(
            0).uniform(-75, -50, 30), jnp.float32)})
        st = snn.SpikeTrainLattice(snn.RateSpikeTrain(), id=3)
        st.populate(5, 6, rate=0.4)
        net = snn.LatticeNetwork.generate_network([lat], [st])
        net.connect(3, 0, lambda x, y: x == y, lambda x, y: 20.0)
        net.set_dt(0.05)
        return net

    j, t = both(build, False, False)
    for net in (j, t):
        net.run_lattices(30)
    assert_networks_match(t, j, RTOL, ATOL)
    for net in (j, t):
        net.reset_timing()
        net.run_lattices(10)
    assert_networks_match(t, j, RTOL, ATOL)
    assert t.internal_clock == 10


def test_network_errors_match_jax():
    for pkg in (snn, snt):
        dev = {} if pkg is snn else {"device": "cpu"}
        a = pkg.Lattice(pkg.Izhikevich(), id=0, **dev)
        a.populate(3, 3)
        net = pkg.LatticeNetwork.generate_network([a])
        b = pkg.Lattice(pkg.Izhikevich(), id=0, **dev)
        b.populate(3, 3)
        with pytest.raises(pkg.errors.LatticeNetworkError):
            net.add_lattice(b)
        c = pkg.Lattice(pkg.LeakyIntegrateAndFire(), id=1, **dev)
        c.populate(3, 3)
        with pytest.raises(pkg.errors.LatticeNetworkError):
            net.add_lattice(c)
        st = pkg.SpikeTrainLattice(pkg.RateSpikeTrain(), id=2, **dev)
        st.populate(3, 3)
        net.add_spike_train_lattice(st)
        with pytest.raises(pkg.errors.LatticeNetworkError):
            net.add_spike_train_lattice(pkg.SpikeTrainLattice(
                pkg.PoissonSpikeTrain(), id=5, **dev))
        with pytest.raises(pkg.errors.LatticeNetworkError):
            net.connect(0, 2, lambda x, y: True)
        with pytest.raises(KeyError):
            net.connect(0, 9, lambda x, y: True)
        with pytest.raises(KeyError):
            net.connect(9, 0, lambda x, y: True)
        with pytest.raises(pkg.errors.LatticeNetworkError):
            net.lookup_weight((0, (5, 5)), (0, (0, 0)))
        with pytest.raises(pkg.errors.LatticeNetworkError):
            net.lookup_weight((7, (0, 0)), (0, (0, 0)))
        with pytest.raises(ValueError):
            st.populate(4, 4)
    assert issubclass(LatticeNetworkError, ValueError)


def test_paths_left_for_later_raise():
    _, t = both(mixed_net, False, False)
    t.chemical_synapse = True      # chemical networks run (no NT inserted)
    t.run_lattices(1)
    assert t.internal_clock == 4 and t._last_run_fused is False
    t.chemical_synapse = False
    t.update_connecting_graph_history = True   # the flat COO runner
    t.run_lattices(1)
    assert t.internal_clock == 5 and len(t.connecting_graph_history) == 1
    t.update_connecting_graph_history = False
    # pipelines and sharding are ported (parallel/): a chain takes no
    # spike-train lattice, and sharding keeps the clock
    from spiking_neural_networks_tpu_torch.parallel import (
        make_lattice_mesh, make_pipeline_mesh)
    cpus = [torch.device("cpu")] * len(t.lattices)
    with pytest.raises(LatticeNetworkError, match="spike-train"):
        t.run_lattices_pipelined(3, mesh=make_pipeline_mesh(len(cpus),
                                                            devices=cpus))
    t.shard(make_lattice_mesh(2, devices=cpus[:1] * 2))
    assert t.spike_train_lattices[2].blocks is not None
    t.electrical_synapse = False
    t.run_lattices(5)              # neither synapse: no step, as in JAX
    assert t.internal_clock == 5


def test_network_from_carries_everything():
    j = mixed_net(hist=HISTORY_KINDS["eeg"](reference_voltage=0.1))
    j.run_lattices(7)
    t = snt.convert.network_from(j, "cpu")
    assert list(t.lattices) == list(j.lattices)
    assert t.internal_clock == j.internal_clock == 10
    exc = t.lattices[0]
    assert exc.do_plasticity and exc.update_grid_history
    assert exc.grid_history.kind == "eeg"
    assert exc.grid_history.reference_voltage == 0.1
    assert isinstance(t.spike_train_lattices[2].model, snt.RateSpikeTrain)
    assert t.device == torch.device("cpu")
    for key, (s, d, w) in j.connections.items():
        np.testing.assert_array_equal(t.connections[key][2], np.asarray(w))
    for lid, jl in j.lattices.items():
        for k, v in jl.state.items():
            np.testing.assert_array_equal(t.lattices[lid].state[k].numpy(),
                                          np.asarray(v), err_msg=k)

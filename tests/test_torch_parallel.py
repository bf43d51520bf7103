"""The port's `parallel` package on virtual CPU meshes: row-block sharding
of one lattice (`parallel.lattice_sharding`), the sharded stencil kernel
route (its twin on the CPU), and the batched (dp, tp) step
(`parallel.sharding`).

Inputs come from a NumPy seed; JAX lattices are carried into the port by
`convert`.  Tolerances:

* port sharded against port unsharded: bit for bit on stencil and sparse
  graphs (the blocks do each cell's arithmetic in the same order), rtol
  1e-6 / atol 1e-5 with equal firing times on dense graphs (a column
  block's product sums in another order), the JAX package's own;
* port against the JAX package (its 8 virtual CPU devices, from
  tests/conftest.py): one step within rtol 1e-5, runs within the
  reference's 2 mV with firing times within 2 steps.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.ops import pallas_stencil
from spiking_neural_networks_tpu.parallel import make_lattice_mesh as jax_mesh
from spiking_neural_networks_tpu.parallel import shard_lattice as jax_shard
from spiking_neural_networks_tpu.parallel import sharding as jax_sharding
from spiking_neural_networks_tpu_torch import convert
from spiking_neural_networks_tpu_torch.core.history import EEGHistory
from spiking_neural_networks_tpu_torch.errors import LatticeNetworkError
from spiking_neural_networks_tpu_torch.ops.graph import (DenseGraph,
                                                         dense_to_sparse)
from spiking_neural_networks_tpu_torch.parallel import (
    make_lattice_mesh, shard_lattice, sharding, unshard_lattice)
from spiking_neural_networks_tpu_torch.parallel.lattice_sharding import (
    sharded_kernel_config)

torch.set_num_threads(1)
CPU = torch.device("cpu")


def cpu_mesh(n):
    return make_lattice_mesh(n, devices=[CPU] * n)


@pytest.fixture(scope="module")
def jmesh():
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    return jax_mesh(8)


def assert_bits(a, b, what):
    """Every state leaf of port lattices ``a`` and ``b`` equal bit for bit
    (NaN included), and their weights."""
    assert set(a.state) == set(b.state)
    for k in a.state:
        x, y = a.state[k], b.state[k]
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f"{what}: state[{k}] differs"
    if getattr(a, "graph", None) is not None:
        assert torch.equal(a.graph.weights, b.graph.weights), what


def assert_near_jax(t, j, one_step=False):
    """Port lattice ``t`` against JAX lattice ``j``: after one step every
    float leaf within rtol 1e-5; after a run v within 2 mV and the firing
    times within 2 steps (the same neurons fired)."""
    if one_step:
        for k, want in j.state.items():
            want = np.asarray(want)
            if want.dtype.kind == "f":
                np.testing.assert_allclose(t.state[k].numpy(), want,
                                           rtol=1e-5, atol=1e-5, err_msg=k)
        return
    np.testing.assert_allclose(t.state["v"].numpy(), np.asarray(j.state["v"]),
                               rtol=0, atol=2.0)
    lt = t.state["last_firing_time"].numpy().astype(np.int64)
    lj = np.asarray(j.state["last_firing_time"]).astype(np.int64)
    np.testing.assert_array_equal(lt >= 0, lj >= 0)
    assert np.abs(lt - lj).max() <= 2


def jax_stencil(rows=32, cols=32, chemical=False, plasticity=True, seed=0,
                fire=0):
    """tests/test_parallel.py's stencil lattice (radius 1.5, keep 0.8),
    with ``fire`` neurons set above threshold at step 0."""
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(rows, cols, gap_conductance=10.0)
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-65, 30, rows * cols).astype(np.float32)
    v0[rng.permutation(rows * cols)[:fire]] = 40.0
    lat.state["v"] = jnp.asarray(v0)
    lat.connect_stencil(radius=1.5, keep_prob=0.8, seed=3)
    lat.do_plasticity = plasticity
    if chemical:
        s = lat.state
        for t in ("AMPA", "NMDA"):
            s = lat.model.insert_receptor(s, t)
        for t in ("AMPA", "NMDA"):
            s = lat.model.insert_neurotransmitter(s, t)
        lat.state = s
        lat.chemical_synapse = True
    return lat


def port(jlat):
    lat = convert.lattice_from(jlat, device="cpu") \
        if isinstance(jlat, snn.Lattice) \
        else convert.reward_lattice_from(jlat, snt.Izhikevich(), "cpu")
    lat.use_kernel = False
    return lat


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def test_make_lattice_mesh_raises_past_the_devices():
    with pytest.raises(ValueError):
        make_lattice_mesh(9, devices=[CPU] * 8)
    with pytest.raises(ValueError):
        make_lattice_mesh(torch.cuda.device_count() + 1)
    if not torch.cuda.is_available():
        # no CUDA device: a CPU mesh only where the caller names it
        with pytest.raises(ValueError, match="name the mesh's devices"):
            make_lattice_mesh()
    mesh = make_lattice_mesh(8, devices=[CPU] * 8)
    assert mesh.shape == {"tp": 8} and mesh.size == 8
    assert list(mesh.devices) == [CPU] * 8


def test_make_mesh_shape():
    mesh = sharding.make_mesh(8, devices=[CPU] * 8)
    assert mesh.devices.shape == (2, 4)
    assert mesh.axis_names == ("dp", "tp")
    if jax.device_count() >= 8:
        jm = jax_sharding.make_mesh(8)
        assert jm.devices.shape == mesh.devices.shape
        assert tuple(jm.axis_names) == mesh.axis_names
    if torch.cuda.device_count() < 8:
        with pytest.raises(ValueError):
            sharding.make_mesh(8)


# ---------------------------------------------------------------------------
# row-block sharding of one lattice
# ---------------------------------------------------------------------------

CASES = {
    # tests/test_parallel.py's STDP lattice (slow there: JAX unsharded)
    "stdp": (dict(fire=16), 100, False),
    # its chemical lattice (JAX sharded)
    "chemical": (dict(chemical=True, plasticity=False), 60, True),
    # one row a block; STDP's 2-row ghost depth spans two neighbours
    "8x8-stdp": (dict(rows=8, cols=8, fire=8), 100, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_stencil_lattice(case, jmesh):
    kw, steps, jax_sharded = CASES[case]
    j = jax_stencil(**kw)
    ref, lat = port(j), port(j)
    shard_lattice(lat, cpu_mesh(8))
    assert [b.rows for b in lat.blocks] == [
        (p * j.rows // 8, (p + 1) * j.rows // 8) for p in range(8)]
    ref.run_lattice(steps)
    lat.run_lattice(steps)
    assert lat._last_run_fused is False
    assert_bits(ref, lat, case)
    assert (lat.state["last_firing_time"] >= 0).any()
    if jax_sharded:
        jax_shard(j, jmesh)
    j.run_lattice(steps)
    assert_near_jax(lat, j)


def test_sharded_lattice_one_step_matches_jax(jmesh):
    j = jax_stencil(chemical=True, fire=16)
    lat = port(j)
    lat.shard(cpu_mesh(8))
    jax_shard(j, jmesh)
    j.run_lattice(1)
    lat.run_lattice(1)
    assert_near_jax(lat, j, one_step=True)


def test_unsplittable_rows_stay_unsharded():
    j = jax_stencil(rows=30, cols=32, fire=16)
    ref, lat = port(j), port(j)
    mesh = cpu_mesh(8)
    shard_lattice(lat, mesh)
    assert lat.blocks is None and lat.mesh is mesh
    ref.run_lattice(40)
    lat.run_lattice(40)
    assert_bits(ref, lat, "30 x 32")


def kernel_lattice(radius, rows=32, cols=32):
    lat = snt.Lattice(snt.Izhikevich(), device="cpu")
    lat.populate(rows, cols, gap_conductance=10.0)
    lat.connect_stencil(radius=radius, keep_prob=0.8, seed=3)
    v0 = np.random.default_rng(0).uniform(-65, 30, rows * cols)
    v0[::37] = 40.0
    lat.apply(lambda s: {**s, "v": torch.tensor(v0, dtype=torch.float32)})
    lat.use_kernel = True
    return lat


@pytest.mark.parametrize("radius", [1.5, 2.0])
@pytest.mark.parametrize("shards", [4, 8])
def test_sharded_kernel_route(radius, shards, jmesh):
    """The sharded composition on the CPU (each block's `StencilRun` runs
    the twin): K and g as the JAX package's `sharded_multistep_config`
    (whose g here is halo * K), the state equal to the unsharded kernel
    route's, and 50 steps = calls of K plus the remainder."""
    ref, lat = kernel_lattice(radius), kernel_lattice(radius)
    ref.run_lattice(50)
    assert ref._last_run_fused == ("kernel", False)
    lat.shard(cpu_mesh(shards))
    lat.run_lattice(50)
    tag, designs, k_steps, ghost = lat._last_run_fused
    assert tag == "sharded" and len(designs) == shards
    jg = snn.StencilGraph.build(32, 32, snn.radius_offsets(radius),
                                keep_prob=0.8, seed=3)
    want = pallas_stencil.sharded_multistep_config(
        jg, jax_mesh(shards, devices=jax.devices()[:shards]))
    assert (k_steps, ghost) == want
    assert (k_steps, ghost) == sharded_kernel_config(lat.graph.offsets,
                                                     32 // shards)
    block = 32 // shards
    assert lat.blocks[0].ext == (0, block + ghost)
    assert lat.blocks[1].ext == (block - ghost, 2 * block + ghost)
    assert_bits(ref, lat, "kernel route")
    assert (lat.state["last_firing_time"] >= 0).any()
    # a second run keeps each block's StencilRun and goes on bit for bit
    kept = {p: r[0] for p, r in lat._shard.kernel_runs.items()}
    ref.run_lattice(14)
    lat.run_lattice(14)
    assert {p: r[0] for p, r in lat._shard.kernel_runs.items()} == kept
    assert_bits(ref, lat, "second run")


def test_sharded_kernel_route_takes_no_history():
    lat = kernel_lattice(2.0)
    lat.shard(cpu_mesh(4))
    lat.update_grid_history = True
    lat.run_lattice(20)
    assert lat._last_run_fused is False
    lat.update_grid_history = False
    lat.run_lattice(20)
    assert lat._last_run_fused[0] == "sharded"
    assert lat.internal_clock == 40


@pytest.mark.parametrize("chunk", [None, 16])
@pytest.mark.parametrize("kind", ["grid", "eeg"])
def test_sharded_histories(kind, chunk):
    """Grid and EEG histories of a sharded lattice (the plain route per
    block, read from the assembled owned rows) equal the unsharded plain
    route's, chunked and not."""
    def build():
        lat = kernel_lattice(1.5)
        lat.update_grid_history = True
        lat.history_chunk = chunk
        if kind == "eeg":
            lat.grid_history = EEGHistory()
        return lat
    ref, lat = build(), build()
    ref.use_kernel = False
    lat.shard(cpu_mesh(8))
    ref.run_lattice(50)
    lat.run_lattice(50)
    assert_bits(ref, lat, kind)
    hr = np.stack(ref.grid_history.history)
    hl = np.stack(lat.grid_history.history)
    assert hr.shape == hl.shape and hr.shape[0] == 50
    np.testing.assert_array_equal(hr, hl)


def staggered(lat, n, fire, rng):
    """``fire`` neurons above threshold at step 0 and, where ``fire``,
    half the neurons with a past firing time of 5, so that the first
    spikes' STDP deltas are not zero."""
    v0 = rng.uniform(-65, 30, n).astype(np.float32)
    if fire:
        v0[rng.permutation(n)[:fire]] = 40.0
        lft = np.full(n, -1, np.int32)
        lft[1::2] = 5
        lat.state["last_firing_time"] = jnp.asarray(lft)
    lat.state["v"] = jnp.asarray(v0)


def dense_jax(fire=0):
    """tests/test_parallel.py's dense lattice (8 x 8, 40% edges, STDP)."""
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(8, 8, gap_conductance=10.0)
    rng = np.random.default_rng(1)
    staggered(lat, 64, fire, rng)
    mask = rng.random((64, 64)) < 0.4
    np.fill_diagonal(mask, False)
    w = rng.uniform(0.5, 1.5, (64, 64)).astype(np.float32) * mask
    lat.graph = snn.DenseGraph(jnp.asarray(w), jnp.asarray(mask))
    lat.do_plasticity = True
    return lat


def test_sharded_dense_graph_lattice(jmesh):
    j = dense_jax()
    ref, lat = port(j), port(j)
    lat.shard(cpu_mesh(8))
    assert isinstance(lat.graph, DenseGraph)
    ref.run_lattice(80)
    lat.run_lattice(80)
    for a, b in ((ref.state["v"], lat.state["v"]),
                 (ref.graph.weights, lat.graph.weights)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-5)
    assert torch.equal(ref.state["last_firing_time"],
                       lat.state["last_firing_time"])
    jax_shard(j, jmesh)
    j.run_lattice(80)
    assert_near_jax(lat, j)
    np.testing.assert_allclose(lat.graph.weights.numpy(),
                               np.asarray(j.graph.weights), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_sharded_column_graph_with_firing(layout):
    """Dense and sparse graphs with neurons firing from step 0, so STDP
    moves the weights: a sparse block keeps its destinations' edges in
    order (bits), a dense block's column product sums in another order."""
    ref, lat = port(dense_jax(fire=12)), port(dense_jax(fire=12))
    if layout == "sparse":
        for x in (ref, lat):
            x.graph = dense_to_sparse(x.graph)
    w0 = ref.graph.weights.clone()
    lat.shard(cpu_mesh(8))
    ref.run_lattice(80)
    lat.run_lattice(80)
    assert not torch.equal(ref.graph.weights, w0)
    assert torch.equal(ref.state["last_firing_time"],
                       lat.state["last_firing_time"])
    if layout == "sparse":
        assert_bits(ref, lat, layout)
        assert torch.equal(ref.graph.src, lat.graph.src)
    else:
        np.testing.assert_allclose(ref.state["v"].numpy(),
                                   lat.state["v"].numpy(), rtol=1e-6,
                                   atol=1e-5)
        np.testing.assert_allclose(ref.graph.weights.numpy(),
                                   lat.graph.weights.numpy(), rtol=1e-6,
                                   atol=1e-5)


def reward_jax(fire=0):
    """tests/test_parallel.py's reward lattice (8 x 8, radius 1.5)."""
    lat = snn.RewardModulatedLattice(snn.Izhikevich())
    lat.populate(8, 8, gap_conductance=10.0)
    staggered(lat, 64, fire, np.random.default_rng(2))
    lat.connect_stencil(radius=1.5, keep_prob=0.8, seed=7)
    return lat


@pytest.mark.parametrize("fire", [0, 10])
def test_sharded_reward_lattice(fire, jmesh):
    """R-STDP traces sharded like the weights; the dopamine replicated."""
    j = reward_jax(fire)
    ref, lat = port(j), port(j)
    if fire:
        for x in (ref, lat):
            x.update_grid_history = True
            x.grid_history = snt.history.SpikeHistory()
    lat.shard(cpu_mesh(8))
    w0 = ref.graph.weights.clone()
    ref.run_lattice_with_reward(0.5, 60)
    lat.run_lattice_with_reward(0.5, 60)
    assert_bits(ref, lat, "reward")
    if fire:
        np.testing.assert_array_equal(np.stack(ref.grid_history.history),
                                      np.stack(lat.grid_history.history))
    for k in ref.trace:
        assert torch.equal(ref.trace[k], lat.trace[k]), k
    assert lat.dopamine == ref.dopamine > 0
    assert lat._last_run_fused is False
    if fire:
        assert not torch.equal(lat.graph.weights, w0)
    jax_shard(j, jmesh)
    j.run_lattice_with_reward(0.5, 60)
    assert_near_jax(lat, j)
    np.testing.assert_allclose(lat.graph.weights.numpy(),
                               np.asarray(j.graph.weights), rtol=1e-4,
                               atol=1e-3)
    assert abs(lat.dopamine - j.dopamine) <= 1e-5 * j.dopamine


@pytest.mark.parametrize("train", ["poisson", "rate"])
def test_sharded_spike_train(train):
    """A sharded train's spikes (and grid history) equal the unsharded
    train's: a Poisson train draws the whole plane from its generator."""
    def build():
        st = snt.SpikeTrainLattice(
            snt.PoissonSpikeTrain() if train == "poisson"
            else snt.RateSpikeTrain(), device="cpu")
        if train == "poisson":
            st.rows, st.cols = 16, 8
            st.state = st.model.init_from_firing_rate(128, 100.0,
                                                      device="cpu")
        else:
            st.populate(16, 8, rate=2.0)
        st.update_grid_history = True
        return st
    ref, st = build(), build()
    st.shard(cpu_mesh(8))
    ref.run_lattice(40)
    st.run_lattice(40)
    assert_bits(ref, st, train)
    assert (st.state["last_firing_time"] >= 0).sum() > 10
    np.testing.assert_array_equal(np.stack(ref.grid_history.history),
                                  np.stack(st.grid_history.history))


def test_sharded_views_and_reshard():
    """The whole state stays readable; ``apply``, an item set and an edit
    re-shard; two runs equal one; unsharding gives an ordinary lattice."""
    j = jax_stencil(rows=16, cols=16, fire=8)
    ref, lat = port(j), port(j)
    lat.shard(cpu_mesh(4))
    assert lat.state["v"].shape == (256,)
    assert [b.device for b in lat.blocks] == [CPU] * 4
    v1 = torch.linspace(-70.0, 35.0, 256)
    for x in (ref, lat):
        x.run_lattice(10)
        x.apply(lambda s: {**s, "v": v1.clone()})
        x.run_lattice(10)
        x.state["w"] = x.state["w"] + 1.0
        x.run_lattice(10)
        x.edit_weight((3, 3), (3, 4), 2.5)
        x.run_lattice(10)
    assert lat.lookup_weight((3, 3), (3, 4)) == 2.5
    assert_bits(ref, lat, "views")
    assert lat.internal_clock == 40
    unshard_lattice(lat)
    assert lat.blocks is None and lat.mesh is None
    ref.run_lattice(5)
    lat.run_lattice(5)
    assert_bits(ref, lat, "unsharded")


# ---------------------------------------------------------------------------
# the batched (dp, tp) step
# ---------------------------------------------------------------------------


def batched_inputs(batch=4, n=32, seed=0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-65, 30, (batch, n)).astype(np.float32)
    v0[:, ::5] = 40.0
    lft = np.full((batch, n), -1, np.int32)
    lft[:, 1::3] = 5
    mask = rng.random((batch, n, n)) < 0.4
    w = (rng.uniform(0.5, 1.5, (batch, n, n)) * mask).astype(np.float32)
    return v0, lft, w, mask


@pytest.mark.parametrize("steps", [1, 10])
def test_sharded_training_step(steps, jmesh):
    """B = 4, N = 32 over a (2, 4) virtual mesh against the JAX package's
    sharded step on its 8 devices (rtol 1e-5) and the port's unsharded
    step (a (1, 1) mesh; the column products sum in another order)."""
    v0, lft, w, mask = batched_inputs()
    jm = jax_sharding.make_mesh(8)
    js = jax_sharding.batched_state(snn.Izhikevich(), 4, 32,
                                    gap_conductance=10.0)
    js["v"], js["last_firing_time"] = jnp.asarray(v0), jnp.asarray(lft)
    js, jw, jmask = jax_sharding.shard_batched_inputs(
        jm, js, jnp.asarray(w), jnp.asarray(mask))
    jstep, _ = jax_sharding.make_sharded_training_step(jm, snn.Izhikevich())
    pp = {k: jnp.float32(v) for k, v in snn.STDP().params.items()}
    runs = {}
    for name, mesh in (("sharded", sharding.make_mesh(8, devices=[CPU] * 8)),
                       ("whole", sharding.make_mesh(1, devices=[CPU]))):
        ts = sharding.batched_state(snt.Izhikevich(), 4, 32,
                                    gap_conductance=10.0)
        ts["v"], ts["last_firing_time"] = (torch.from_numpy(v0),
                                           torch.from_numpy(lft))
        ts, tw, tmask = sharding.shard_batched_inputs(
            mesh, ts, torch.from_numpy(w), torch.from_numpy(mask))
        step, rule = sharding.make_sharded_training_step(mesh, snt.Izhikevich())
        for clock in range(steps):
            ts, tw, spk = step(ts, tw, tmask, clock, rule.params)
        runs[name] = (ts["v"].whole(), tw.whole(), spk.whole(),
                      ts["last_firing_time"].whole())
    for clock in range(steps):
        js, jw, jspk = jstep(js, jw, jmask, jnp.int32(clock), pp)
    v, tw, spk, lft_t = runs["sharded"]
    assert not torch.equal(tw, torch.from_numpy(w))
    np.testing.assert_allclose(v.numpy(), np.asarray(js["v"]), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(lft_t.numpy(),
                                  np.asarray(js["last_firing_time"]))
    np.testing.assert_array_equal(spk.numpy(), np.asarray(jspk))
    for a, b in zip(runs["sharded"], runs["whole"]):
        np.testing.assert_allclose(a.numpy().astype(np.float64),
                                   b.numpy().astype(np.float64), rtol=1e-5,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# sharded networks (the structured runners' plain route over the blocks)
# ---------------------------------------------------------------------------


def jax_full_feature_net():
    """tests/test_parallel.py's `test_sharded_network_full_feature`
    network: two 8 x 8 chemical Izhikevich lattices (AMPA), STDP on the
    first, a rate train, one-to-one and row-wise connections."""
    rng = np.random.default_rng(4)
    lats = []
    for i, seed in ((0, 5), (1, 6)):
        lat = snn.Lattice(snn.Izhikevich(), id=i)
        lat.populate(8, 8, gap_conductance=10.0)
        lat.state["v"] = jnp.asarray(rng.uniform(-65, 25, 64), jnp.float32)
        lats.append(lat)
    for lat, seed in zip(lats, (5, 6)):
        lat.connect_stencil(radius=1.5, keep_prob=0.9, seed=seed)
    lats[0].do_plasticity = True
    st = snn.SpikeTrainLattice(snn.RateSpikeTrain(), id=2)
    st.populate(8, 8, rate=2.0, v_th=30.0)
    for lat in lats:
        s = lat.model.insert_receptor(lat.state, "AMPA")
        lat.state = lat.model.insert_neurotransmitter(s, "AMPA")
    st.state = st.model.insert_neurotransmitter(st.state, "AMPA")
    net = snn.LatticeNetwork.generate_network(lats, [st])
    net.chemical_synapse = True
    net.connect_vectorized(0, 1, lambda pr, pc, qr, qc: np.where(
        (pr == qr) & (pc == qc), 1.0, np.nan))
    net.connect_vectorized(2, 0, lambda pr, pc, qr, qc: np.where(
        (pr == qr), 0.8, np.nan))
    return net


def test_sharded_network_full_feature():
    """Every member row-block sharded (`LatticeNetwork.shard`): bit for
    bit the unsharded structured runner, within the criterion of the JAX
    package's `run_lattices` (its test is slow: unsharded)."""
    j = jax_full_feature_net()
    ref, net = (convert.network_from(j, device="cpu") for _ in range(2))
    mesh = cpu_mesh(8)
    net.shard(mesh)
    assert net.mesh is mesh and net.get_lattice(1).blocks[7].rows == (7, 8)
    ref.run_lattices(60)
    net.run_lattices(60)
    assert net._last_run_fused is False
    for i in (0, 1):
        assert_bits(ref.get_lattice(i), net.get_lattice(i), f"lattice {i}")
        assert net.get_lattice(i).internal_clock == 60
    assert_bits(ref.get_spike_train_lattice(2),
                net.get_spike_train_lattice(2), "train")
    for key in ref.connections:
        np.testing.assert_array_equal(ref.connections[key][2],
                                      net.connections[key][2])
    assert (net.get_lattice(0).state["last_firing_time"] >= 0).any()
    j.run_lattices(60)
    for i in (0, 1):
        assert_near_jax(net.get_lattice(i), j.get_lattice(i))


@pytest.mark.parametrize("train", ["rate", "poisson"])
def test_sharded_network_histories_and_dense(train):
    """A dense-graph member (column blocks), a lattice whose rows the mesh
    does not split (one block for the run), grid histories and a Poisson
    or rate train: bit for bit the unsharded runner (the dense member
    within the dense tolerance)."""
    def build():
        rng = np.random.default_rng(8)
        a = snt.Lattice(snt.Izhikevich(), id=0, device="cpu")
        a.populate(8, 8, gap_conductance=10.0)
        a.connect_stencil(radius=2.0, keep_prob=0.8, seed=2)
        a.do_plasticity = True
        b = snt.Lattice(snt.Izhikevich(), id=1, device="cpu")
        b.populate(8, 8, gap_conductance=10.0)
        mask = rng.random((64, 64)) < 0.2
        b.graph = DenseGraph(
            torch.from_numpy((rng.uniform(0.5, 1.5, (64, 64)) * mask)
                             .astype(np.float32)), torch.from_numpy(mask))
        c = snt.Lattice(snt.Izhikevich(), id=3, device="cpu")
        c.populate(6, 8, gap_conductance=10.0)
        c.connect_stencil(radius=1.0, seed=4)
        for x in (a, b, c):
            v0 = rng.uniform(-65, 30, x.n).astype(np.float32)
            v0[::5] = 40.0
            x.apply(lambda s: {**s, "v": torch.from_numpy(v0)})
            x.update_grid_history = True
        st = snt.SpikeTrainLattice(
            snt.PoissonSpikeTrain() if train == "poisson"
            else snt.RateSpikeTrain(), id=2, device="cpu")
        if train == "poisson":
            st.rows, st.cols = 8, 8
            st.state = st.model.init_from_firing_rate(64, 200.0,
                                                      device="cpu")
        else:
            st.populate(8, 8, rate=2.0)
        net = snt.LatticeNetwork.generate_network([a, b, c], [st])
        one = lambda p, q: p == q
        net.connect(0, 1, one, lambda p, q: 2.0)
        net.connect(2, 0, one, lambda p, q: 1.5)
        net.connect(1, 3, lambda p, q: p[0] == q[0] + 2 and p[1] == q[1],
                    lambda p, q: 1.0)
        net.history_chunk = 16
        return net
    ref, net = build(), build()
    net.shard(cpu_mesh(4))
    assert net.get_lattice(3).blocks is None
    ref.run_lattices(40)
    net.run_lattices(40)
    for i in (0, 3):
        assert_bits(ref.get_lattice(i), net.get_lattice(i), f"lattice {i}")
    np.testing.assert_allclose(net.get_lattice(1).state["v"].numpy(),
                               ref.get_lattice(1).state["v"].numpy(),
                               rtol=1e-6, atol=1e-5)
    assert torch.equal(net.get_lattice(1).state["last_firing_time"],
                       ref.get_lattice(1).state["last_firing_time"])
    assert_bits(ref.get_spike_train_lattice(2),
                net.get_spike_train_lattice(2), "train")
    for i in (0, 3):
        np.testing.assert_array_equal(
            np.stack(ref.get_lattice(i).grid_history.history),
            np.stack(net.get_lattice(i).grid_history.history))
    assert len(net.get_lattice(1).grid_history.history) == 40
    assert net.get_lattice(3).internal_clock == 40


def test_sharded_reward_network():
    """The ALIF reward network of tests/test_pallas_reward.py (a reward
    lattice, a plastic lattice, a rate train, a reward connection) with
    every member sharded: bit for bit the unsharded structured reward
    runner; the reward connection's weights move."""
    from torch_networks import reward_net
    j = reward_net("rate", model="alif")
    ref, net = (convert.reward_network_from(j, "cpu") for _ in range(2))
    w0 = ref.reward_connections[(1, 0)][2].copy()
    net.shard(cpu_mesh(4))
    ref.run_lattices_with_reward(0.5, 120)
    net.run_lattices_with_reward(0.5, 120)
    assert net._last_run_fused is False
    assert net.dopamine == ref.dopamine
    for i in (0, 1):
        a = {**ref.lattices, **ref.reward_modulated_lattices}[i]
        b = {**net.lattices, **net.reward_modulated_lattices}[i]
        assert_bits(a, b, f"lattice {i}")
        if getattr(a, "trace", None) is not None:
            for k in a.trace:
                assert torch.equal(a.trace[k], b.trace[k]), k
            assert b.dopamine == net.dopamine
    for key, conn in ref.reward_connections.items():
        for x, y in zip(conn[2:], net.reward_connections[key][2:]):
            np.testing.assert_array_equal(x, y)
    assert not np.array_equal(net.reward_connections[(1, 0)][2], w0)


def small_network(cls=snt.LatticeNetwork):
    rng = np.random.default_rng(5)
    lats = []
    for i in (0, 1):
        x = snt.Lattice(snt.Izhikevich(), id=i, device="cpu")
        x.populate(8, 8, gap_conductance=10.0)
        x.connect_stencil(radius=1.5, keep_prob=0.8, seed=i)
        v0 = rng.uniform(-65, 30, x.n).astype(np.float32)
        x.apply(lambda s: {**s, "v": torch.from_numpy(v0)})
        lats.append(x)
    net = cls.generate_network(lats, [])
    net.connect(0, 1, lambda p, q: p == q, lambda p, q: 2.0)
    return net


@pytest.mark.parametrize("case", ["graph_history", "subclass",
                                  "unstructured", "reward_graph_history"])
def test_sharded_network_takes_no_flat_runner(case):
    """What would send a sharded network to the flat COO runner (which
    steps every member whole on one device) raises before any step, and
    the members stay sharded."""
    if case == "reward_graph_history":
        from torch_networks import reward_net
        net = convert.reward_network_from(reward_net("rate", model="alif"),
                                          "cpu")
        net.update_connecting_graph_history = True
        run = lambda: net.run_lattices_with_reward(0.5, 2)
    else:
        net = small_network(type("Sub", (snt.LatticeNetwork,), {})
                            if case == "subclass" else snt.LatticeNetwork)
        net.update_connecting_graph_history = case == "graph_history"
        net.structured = case != "unstructured"
        run = lambda: net.run_lattices(2)
    net.shard(cpu_mesh(4))
    with pytest.raises(LatticeNetworkError, match="structured runner"):
        run()
    for lat in net._neuron_lattices().values():
        assert len(lat.blocks) == 4 and lat.internal_clock == 0


def test_sharded_agent_takes_no_jit_environment():
    """The closed loop's tiers step the agent whole on one device, so a
    sharded agent raises; the host-loop `Environment` steps its blocks."""
    from spiking_neural_networks_tpu_torch.interactable import (
        Environment, JitEnvironment)
    agent = small_network().get_lattice(0)
    agent.shard(cpu_mesh(4))
    env = JitEnvironment(agent, {"x": torch.zeros(())},
                         lambda e, s: s, None, lambda e, s: e)
    with pytest.raises(ValueError, match="sharded agent"):
        env.run(2)

    class State:
        def update_state(self, agent):
            pass
    Environment(agent, State(), lambda s, a: None).run(2)
    assert agent.internal_clock == 2 and len(agent.blocks) == 4

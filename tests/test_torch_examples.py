"""The examples of the port (``spiking_neural_networks_tpu_torch/
examples/``) against the JAX package's scripts of ``examples/`` on the
CPU, each at its own size or cut where the plain route sets the cost:

* both packages build each lattice and network from one NumPy seed, equal
  edge for edge (`torch_pipelines.Recorder`, `LatticeRecorder`);
* the JAX package's gate and the port's take the same route, run by run
  (the lattice kernel, the STDP or R-STDP lattice, a network in grid or
  flat mode, the closed loop's kernel tier, or plain), and the port runs
  both its kernel route's twin (``use_kernel=True``) and its plain route;
* the trajectories agree within 2 mV and 2 steps (the reference's
  criterion over its 1000 steps where a chaotic lattice runs longer); a
  Poisson train draws from a JAX key in one package and a
  `torch.Generator` in the other, so its runs agree with every chance of
  firing forced to 0 or 1, and within 1e-4 mV before the first draw that
  can fire;
* ``--device`` takes ``cuda`` or ``cpu`` and nothing else.
"""

import functools
import importlib
import importlib.util
import os

import numpy as np
import pytest
import torch

import torch_pipelines as tp
from torch_pipelines import BAND, ROOT, run_three

from spiking_neural_networks_tpu import interactable as jint
from spiking_neural_networks_tpu.core.lattice import _mask_any
from spiking_neural_networks_tpu.ops import pallas_reward as jpr

torch.set_num_threads(1)

NAMES = ("lattice", "eeg_psd", "lattice_network", "synaptic_pruning",
         "interacting_pools", "rstdp_lattice", "agent_environment",
         "lsm_architecture", "sharded_lattice", "pipelined_network", "stdp",
         "bcm", "raster", "hodgkin_huxley", "morris_lecar", "hopfield")


def jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J = {name: jax_example(name) for name in NAMES}
T = {name: importlib.import_module(
    f"spiking_neural_networks_tpu_torch.examples.{name}") for name in NAMES}


def lattice_pairs(rec):
    """(JAX lattice, its snapshot, port lattice, its snapshot) of each
    port run, in order."""
    n = len(rec.jax)
    assert len(rec.torch) == 2 * n
    return [rec.jax[i % n] + rec.torch[i] for i in range(2 * n)]


def assert_lattice_built_equal(jsnap, tsnap):
    (js, jw), (ts, tw) = jsnap, tsnap
    np.testing.assert_array_equal(tw, jw)
    for k, v in js.items():
        if k in ts:
            np.testing.assert_array_equal(ts[k], v, err_msg=k)


def lft(lat):
    return tp._host(lat.state["last_firing_time"]).astype(np.int64)


def assert_firing_close(jlat, tlat, steps=2):
    a, b = lft(jlat), lft(tlat)
    assert ((a < 0) == (b < 0)).all()
    assert np.abs(a - b).max(initial=0) <= steps


# -- row 6: lattice (the lattice kernel, emitting) ----------------------------


def test_lattice_example_matches_jax(monkeypatch, tmp_path):
    """10 x 10, radius 2, keep 0.8, 5000 steps with a grid history: the
    stencil kernel in both gates (the JAX multi-step kernel emitting v;
    on the card the persistent design, emitting).  A chaotic lattice: the
    first 1000 steps within 2 mV, then every neuron fires in both."""
    tp.outputs_to(monkeypatch, tmp_path, J["lattice"], T["lattice"])
    rec = tp.LatticeRecorder(monkeypatch)

    def saved():
        return np.load(tmp_path / "lattice_history.npy")

    jh = (J["lattice"].main(), saved())[1]
    with tp.kernel(rec, True):
        kh = (T["lattice"].main(device="cpu"), saved())[1]
    with tp.kernel(rec, False):
        ph = (T["lattice"].main(device="cpu"), saved())[1]
    n = len(rec.jax_routes)
    assert set(rec.jax_routes) == {"stencil"} and n >= 1
    assert set(rec.routes()[:len(rec.routes()) // 2]) == {"stencil"}
    assert set(rec.routes()[len(rec.routes()) // 2:]) == {False}
    for jlat, jsnap, tlat, tsnap in lattice_pairs(rec):
        assert_lattice_built_equal(jsnap, tsnap)
        assert (lft(tlat) >= 0).all() and (lft(jlat) >= 0).all()
    for h in (kh, ph):
        assert h.shape == jh.shape == (5000, 10, 10)
        assert np.isfinite(h).all()
        assert np.abs(h[:1000] - jh[:1000]).max() <= 2.0


# -- row 7: eeg_psd ------------------------------------------------------------


def test_eeg_example_matches_jax(monkeypatch, capsys):
    """10 x 10, radius 2, an EEG history over 10000 steps: the stencil
    kernel in both gates; the EEG series within 2 mV a neuron over the
    reference's 1000 steps."""
    rec = tp.LatticeRecorder(monkeypatch)
    run_three(rec, J["eeg_psd"].main, lambda: T["eeg_psd"].main(device="cpu"))
    assert set(rec.jax_routes) == {"stencil"}
    half = len(rec.routes()) // 2
    assert set(rec.routes()[:half]) == {"stencil"}
    assert set(rec.routes()[half:]) == {False}
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and all("series length 10000" in x for x in out)
    for jlat, jsnap, tlat, tsnap in lattice_pairs(rec):
        assert_lattice_built_equal(jsnap, tsnap)
        h = tlat.grid_history
        per_mv = 1.0 / (4 * np.pi * h.conductivity * h.distance)
        a = np.asarray(jlat.grid_history.history, np.float64)
        b = np.asarray(h.history, np.float64)
        assert a.shape == b.shape == (10000,)
        assert np.abs(a[:1000] - b[:1000]).max() <= 2.0 * 100 * per_mv


# -- row 8: lattice_network (grid mode) ----------------------------------------


@pytest.mark.parametrize("force", [True, False], ids=["forced", "free"])
def test_lattice_network_example_matches_jax(monkeypatch, force):
    """Two 3 x 3 lattices and a Poisson train (chance 0.01): grid mode in
    both gates."""
    rec = tp.Recorder(monkeypatch, force=force)
    run_three(rec, J["lattice_network"].main,
              lambda: T["lattice_network"].main(device="cpu"))
    tp.check_routes(rec, "network")
    tp.check_runs(rec, (0,), tp.FORCED if force else tp.FREE, upto=1)


# -- row 9: synaptic_pruning (flat mode) ----------------------------------------


@pytest.mark.parametrize("force", [True, False], ids=["forced", "free"])
def test_synaptic_pruning_example_matches_jax(monkeypatch, force):
    """One trial at connectivity 0.6, cut from 1500 to 300 steps: the
    Hopfield-pruned 7 x 7 + 3 x 3 network and its cue in flat mode in
    both gates, the recall accuracy equal where the cue is forced."""
    for mod in (J["synaptic_pruning"], T["synaptic_pruning"]):
        monkeypatch.setattr(mod, "ITERATIONS", 300)
    rec = tp.Recorder(monkeypatch, force=force)

    def inputs(mod):
        rng = np.random.default_rng(0)
        pattern = (rng.uniform(size=mod.NUM) < 0.5).astype(int)
        w = mod.get_weights(mod.NUM, [2 * pattern - 1], scalar=1.0 / mod.NUM)
        return w, pattern, 0.6, 0.1, rng

    jv, kv, pv = run_three(
        rec, lambda: J["synaptic_pruning"].run_trial(
            *inputs(J["synaptic_pruning"])),
        lambda: T["synaptic_pruning"].run_trial(
            *inputs(T["synaptic_pruning"]), device="cpu"))
    tp.check_routes(rec, "flat")
    tp.check_runs(rec, (1,), tp.FORCED if force else tp.FREE, upto=1)
    if force:
        assert kv == pv == jv


# -- row 10: interacting_pools (flat mode) -------------------------------------


def test_interacting_pools_example_matches_jax(monkeypatch):
    """5 x 5 and 10 x 10 all-to-all pools, cross-coupled: flat mode in
    both gates; no train, so the average-voltage traces agree."""
    rec = tp.Recorder(monkeypatch)
    jv, kv, pv = run_three(
        rec, lambda: J["interacting_pools"].main(iterations=800),
        lambda: T["interacting_pools"].main(iterations=800, device="cpu"))
    tp.check_routes(rec, "flat")
    for (jnet, jsnap), (tnet, tsnap) in zip(rec.jax * 2, rec.torch):
        tp.assert_built_equal(jsnap, tsnap)
        for i in (0, 1):
            assert_firing_close(jnet.lattices[i], tnet.lattices[i])
    for v in (kv, pv):
        for key in ("inh", "exc"):
            assert v[key].shape == (800,)
            assert np.abs(v[key] - jv[key]).max() <= 2.0


# -- row 11: rstdp_lattice (6a) -------------------------------------------------


def test_rstdp_lattice_example_matches_jax(monkeypatch, capsys):
    """4 x 4 all-to-all R-STDP lattice, 1000 rewarded steps: ``connect``
    makes its all-to-all graph a dense graph in both packages, which keeps
    the lattice plain in both gates (6a takes stencil graphs); the
    weights, dopamine and firing agree (R-STDP weights within 32, PERF.md
    section 2)."""
    rec = tp.LatticeRecorder(monkeypatch)
    run_three(rec, J["rstdp_lattice"].main,
              lambda: T["rstdp_lattice"].main(device="cpu"))
    assert rec.jax_routes == [False]
    assert rec.routes() == [False, False]
    assert type(rec.torch[0][0].graph).__name__ == "DenseGraph"
    for jlat, jsnap, tlat, tsnap in lattice_pairs(rec):
        assert_lattice_built_equal(jsnap, tsnap)
        assert_firing_close(jlat, tlat)
        assert tlat.dopamine == pytest.approx(jlat.dopamine, rel=1e-3)
        w = tp._host(tlat.graph.weights)
        assert np.isfinite(w).all()
        assert np.abs(w - np.asarray(jlat.graph.weights)).max() <= 32.0
    assert len(capsys.readouterr().out.splitlines()) == 3


# -- row 12: agent_environment (6d) ---------------------------------------------


def jax_env_tier(env):
    """The JAX closed loop's tier for ``env`` (`interactable.
    JitEnvironment._build`'s gate, asked with the Pallas path forced on):
    "a" (callbacks fused into the kernel), "b" (a kernel launch a step)
    or False."""
    agent = env.agent
    if not _mask_any(agent.state["nt$mask"]) \
            and jpr.supports_lattice(agent):
        cand = jpr.NetSpec(
            (jpr.LatSpec("mod" if agent.do_modulation else "plain",
                         agent.graph.offsets, jpr._model_kind(agent.model),
                         (agent.rows, agent.cols)),), (), (), True)
        if env._hist_sig() is None and jpr.supports_shapes(cand) \
                and env._grid_callbacks_ok():
            return "a"
        if jpr.supports_shapes(cand, chunk=1):
            return "b"
    return False


def test_agent_environment_example_matches_jax(monkeypatch):
    """The 10 x 10 R-STDP agent (radius 2, weights 2) under `JitEnvironment`
    at 200 steps: the JAX gate gives the kernel's tier (b) (its callbacks
    index flat positions), the port's kernel tiers run ((b) on the CPU, the
    twin; a CUDA graph on the card), and its plain route; the rate
    trajectory and the weights' drift agree with the JAX loop's
    statistically (the cues are other draws)."""
    tiers = {"jax": [], "torch": []}
    jrun = jint.JitEnvironment.run_with_reward

    def jax_run(env, n):
        tiers["jax"].append(jax_env_tier(env))
        return jrun(env, n)

    monkeypatch.setattr(jint.JitEnvironment, "run_with_reward", jax_run)
    trun = T["agent_environment"].JitEnvironment.run_with_reward

    def torch_run(env, n, use_kernel):
        env.agent.use_kernel = use_kernel
        out = trun(env, n)
        tiers["torch"].append((env.last_build_fused,
                               env.last_build_env_fused))
        return out

    jv = J["agent_environment"].main(iterations=200)
    got = {}
    for use_kernel in (True, False):
        monkeypatch.setattr(
            T["agent_environment"].JitEnvironment, "run_with_reward",
            lambda env, n, _k=use_kernel: torch_run(env, n, _k))
        got[use_kernel] = T["agent_environment"].main(iterations=200,
                                                      device="cpu")
    assert tiers["jax"] == ["b"] * 20
    assert tiers["torch"] == [(True, False)] * 20 + [(False, False)] * 20
    for v in got.values():
        assert len(v) == len(jv) == 20
        assert all(np.isfinite(v))
        assert abs(np.mean(v) - np.mean(jv)) <= 0.02
    # the kernel tier's twin and the plain route draw the same cues
    assert np.abs(np.array(got[True]) - np.array(got[False])).max() <= 0.01


def test_agent_environment_cue_is_six_distinct_neurons():
    cue = T["agent_environment"].cue_indices
    seen = set()
    for k in range(50):
        idx = cue(torch.tensor(float(k)), 100, 6)
        assert idx.shape == (6,) and len(set(idx.tolist())) == 6
        assert 0 <= int(idx.min()) and int(idx.max()) < 100
        seen |= set(idx.tolist())
    assert len(seen) > 90


# -- row 13: lsm_architecture (the reward network, host loop) ----------------


def test_lsm_architecture_example_matches_jax(monkeypatch):
    """The Poisson row, the 10 x 10 liquid and the 4 x 2 R-STDP readout
    under the host-loop `Environment`, 400 steps with a pulse every 150:
    the readout's histories keep the reward network plain in both packages
    (the JAX network never reaches its kernel gate, the port's runs are
    plain);
    the dopamine trace agrees exactly (it follows the rewards) and the
    readout's voltages within 2 mV over the steps before the first pulse
    (its train is silent until then)."""
    rec = tp.LatticeRecorder(monkeypatch)
    jenv = J["lsm_architecture"].main(iterations=400, period=150)
    envs = []
    for use_kernel in (True, False):
        with tp.kernel(rec, use_kernel):
            envs.append(T["lsm_architecture"].main(iterations=400,
                                                   period=150, device="cpu"))
    assert rec.jax_routes == []
    assert rec.routes() == [False] * 800
    jd = np.asarray(jenv.state.dopamine_history)
    jv = np.stack(jenv.agent.get_reward_modulated_lattice(2)
                  .grid_history.history)
    for env in envs:
        np.testing.assert_allclose(env.state.dopamine_history, jd,
                                   rtol=1e-5, atol=1e-6)
        readout = env.agent.get_reward_modulated_lattice(2)
        v = np.stack(readout.grid_history.history)
        assert v.shape == jv.shape == (400, 4, 2)
        assert np.isfinite(v).all()
        assert np.abs(v[:150] - jv[:150]).max() <= 2.0
        assert len(readout.graph_history) == 400
        np.testing.assert_allclose(
            readout.graph_history[0],
            np.asarray(jenv.agent.get_reward_modulated_lattice(2)
                       .graph_history[0]), rtol=1e-6)


# -- row 14: sharded_lattice ------------------------------------------------------


def test_sharded_lattice_example_matches_jax(monkeypatch, capsys):
    """The STDP lattice cut from 256^2 to 16 x 16 (500 steps): the single
    run takes the STDP lattice kernel in both gates (6a), the sharded run
    the plain step per block in both (JAX: 8 CPU devices, the port: one
    block on the CPU); single and sharded runs agree within 2 mV.  The
    port's sharded run equals its plain single run bit for bit, and its
    kernel-route single run (the twin, another summation order) only under
    the tie rule, so that run may print False."""
    rec = tp.LatticeRecorder(monkeypatch)
    for mod in (J["sharded_lattice"], T["sharded_lattice"]):
        monkeypatch.setattr(mod, "build",
                            functools.partial(mod.build, rows=16, cols=16))
    run_three(rec, J["sharded_lattice"].main,
              lambda: T["sharded_lattice"].main(device="cpu"))
    assert rec.jax_routes == ["stdp", False]
    assert rec.routes() == ["stdp", False, False, False]
    out = [x for x in capsys.readouterr().out.splitlines()
           if "bit-exact" in x]
    assert len(out) == 3
    assert out[0].endswith("True") and out[2].endswith("True")
    pairs = lattice_pairs(rec)
    for jlat, jsnap, tlat, tsnap in pairs:
        assert_lattice_built_equal(jsnap, tsnap)
        dv = np.abs(tp._host(jlat.state["v"]) - tp._host(tlat.state["v"]))
        assert (dv > 2.0).mean() < 0.01
        assert (lft(tlat) >= 0).sum() > 0


# -- row 15: pipelined_network ----------------------------------------------------


def test_pipelined_network_matches_jax():
    """The 4-stage 32 x 32 STDP chain over 4 stages (JAX: 4 CPU devices;
    the port: 4 virtual CPU stages), cut from 1000 to 100 steps: each
    stage's firing within 2 steps and its voltages within 2 mV."""
    from spiking_neural_networks_tpu.parallel import make_pipeline_mesh as jm
    from spiking_neural_networks_tpu_torch.parallel import \
        make_pipeline_mesh as tm
    jnet = J["pipelined_network"].build_chain(stages=4)
    jnet.run_lattices_pipelined(100, mesh=jm(4))
    for use_kernel in (True, False):
        tnet = T["pipelined_network"].build_chain(stages=4, device="cpu")
        for lat in tnet.lattices.values():
            lat.use_kernel = use_kernel
        tnet.run_lattices_pipelined(
            100, mesh=tm(4, devices=[torch.device("cpu")] * 4))
        for k in range(4):
            j, t = jnet.get_lattice(k), tnet.get_lattice(k)
            dv = np.abs(np.asarray(j.state["v"]) - tp._host(t.state["v"]))
            assert (dv > 2.0).mean() < 0.01
            assert (lft(t) >= 0).sum() == (lft(j) >= 0).sum()


def test_pipelined_example_runs_over_the_devices_there_are(capsys):
    T["pipelined_network"].main(device="cpu")
    out = capsys.readouterr().out
    assert "pipeline mesh (1,) on cpu" in out and "stage 0:" in out


# -- rows 16-17: stdp and bcm (the flat COO runner) ------------------------------


@pytest.mark.parametrize("force", [True, False], ids=["forced", "free"])
def test_stdp_example_matches_jax(monkeypatch, force):
    """5 x 5 STDP lattice with a graph history and a 50 Hz train: the
    network reaches no kernel gate in either package (graph histories take
    the flat COO runner); the weights agree where the train is forced."""
    rec = tp.Recorder(monkeypatch, force=force)
    run_three(rec, J["stdp"].main, lambda: T["stdp"].main(device="cpu"))
    assert rec.jax_routes == []
    assert rec.routes() == [False, False]
    (jnet, jsnap), runs = rec.jax[0], rec.torch
    for tnet, tsnap in runs:
        tp.assert_built_equal(jsnap, tsnap)
        jl, tl = jnet.lattices[0], tnet.lattices[0]
        if force:
            assert_firing_close(jl, tl)
            np.testing.assert_allclose(tp._host(tl.graph.weights),
                                       np.asarray(jl.graph.weights),
                                       atol=1e-3)
        else:
            assert BAND(int((lft(jl) >= 0).sum()), int((lft(tl) >= 0).sum()))


def test_bcm_example_matches_jax(monkeypatch):
    """Two BCM trains forced to chances 1 and 0 into one `BCMIzhikevich`
    (500 steps, activity windows of 500): the flat COO runner in both;
    the voltages and the weight history agree."""
    rec = tp.Recorder(monkeypatch, force=True)
    jw, kw, pw = run_three(
        rec, lambda: J["bcm"].main(iterations=500),
        lambda: T["bcm"].main(iterations=500, device="cpu"))
    assert rec.jax_routes == [] and rec.routes() == [False, False]
    (jnet, jsnap), runs = rec.jax[0], rec.torch
    for (tnet, tsnap), w in zip(runs, (kw, pw)):
        tp.assert_built_equal(jsnap, tsnap)
        tp.assert_histories_close(jnet.lattices[1], tnet.lattices[1])
        assert w.shape == jw.shape
        np.testing.assert_allclose(w, jw, rtol=1e-4, atol=1e-4)


# -- row 18: raster (plain) ---------------------------------------------------------


def test_raster_example_matches_jax(monkeypatch, capsys):
    """5 x 5 lixirnet lattice, radius 2 at 80%: ``connect`` yields a dense
    graph, which keeps the lattice plain in both gates; the raster is the
    same."""
    rec = tp.LatticeRecorder(monkeypatch)
    run_three(rec, J["raster"].main, lambda: T["raster"].main(device="cpu"))
    assert set(rec.jax_routes) == {False}
    assert set(rec.routes()) == {False}
    out = capsys.readouterr().out.split("spike raster")
    assert len(out) == 4 and out[1] == out[2] == out[3]
    for jlat, jsnap, tlat, tsnap in lattice_pairs(rec):
        assert_lattice_built_equal(jsnap, tsnap)
        tp.assert_histories_close(jlat, tlat)


# -- rows 19-21: single neurons and the discrete attractor ------------------------


def test_hodgkin_huxley_example_matches_jax(capsys):
    """4 neurons at 0, 10, 25, 50 over 5000 steps (the model's step in a
    loop): the voltage traces within 2 mV and the peak counts equal."""
    J["hodgkin_huxley"].main()
    jout = capsys.readouterr().out
    v = T["hodgkin_huxley"].main(device="cpu")
    assert capsys.readouterr().out == jout
    assert v.shape == (5000, 4) and np.isfinite(v).all()
    import jax
    import spiking_neural_networks_tpu as snn
    model = snn.HodgkinHuxley()
    inputs = jax.numpy.asarray([0.0, 10.0, 25.0, 50.0])

    def step(s, _):
        s, _ = model.step(s, inputs)
        return s, s["v"]

    _, jv = jax.lax.scan(step, model.init_state(4), None, length=5000)
    assert np.abs(v - np.asarray(jv)).max() <= 2.0


def test_morris_lecar_example_matches_jax(tmp_path):
    jv = J["morris_lecar"].main(iterations=800)
    v = T["morris_lecar"].main(iterations=800, csv_path=str(tmp_path / "v"),
                               device="cpu")
    assert v.shape == (800,) and np.abs(v - jv).max() <= 2.0
    assert (tmp_path / "v").read_text().count("\n") == 801


def test_hopfield_example_matches_jax(capsys):
    J["hopfield"].main()
    jout = capsys.readouterr().out
    T["hopfield"].main(device="cpu")
    assert capsys.readouterr().out == jout
    assert jout.count("recovered=True") == 3


# -- command lines ------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_device_option_takes_cuda_or_cpu(name, capsys):
    for argv in (["--device", "tpu"], ["--device"]):
        with pytest.raises(SystemExit) as e:
            T[name].cli(argv)
        assert e.value.code == 2
    assert "--device" in capsys.readouterr().err


@pytest.mark.parametrize("name", NAMES)
def test_cli_passes_its_device(name, monkeypatch):
    monkeypatch.setattr(T[name], "main", lambda **kw: kw)
    assert T[name].cli(["--device", "cpu"]) == {"device": "cpu"}
    assert T[name].cli([]) == {"device": "cuda"}

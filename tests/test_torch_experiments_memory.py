"""The memory pipelines of the port's ``experiments/`` against the JAX
package's scripts on the CPU: ``lsm_setup``, ``schizophrenia_simulation``,
``dopamine_liquid_interaction``, ``bayesian_inference_pipeline``,
``attractor_manifold``, ``tolman_eichenbaum`` and
``heuristic_parameter_search``.

For each pipeline, at a small size (the committed reference TOML's first
grid point or the keyword defaults, cut to a few hundred steps):

* both packages build their network from one NumPy seed, captured at its
  first run (`torch_pipelines.Recorder`), equal edge for edge and state
  for state;
* the JAX package's gate and the port's take the same route, run by run;
  the port runs both its kernel route (on the CPU, the kernel's plain twin;
  ``use_kernel=True``) and its plain route (``use_kernel=False``);
* the trajectories agree.  A Poisson train draws from a JAX key in one
  package and a `torch.Generator` in the other, so the runs agree within
  1e-4 mV up to the first step whose draw can fire, within 2 mV and 2
  steps over the whole run with every chance of firing forced to 0 or 1,
  and in a free run the firing counts lie within the band `BAND` states;
  a Rate-driven run is deterministic and agrees within 2 mV and 2 steps;
* ``--device`` takes ``cuda`` or ``cpu`` and nothing else, and each `main`
  runs end to end into ``tmp_path``.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_pipelines as tp
from torch_pipelines import (BAND, FORCED, FREE, ROOT, check_routes,
                             check_runs, outputs_to, run_three)

import attractor_manifold as Jam  # noqa: E402
import bayesian_inference_pipeline as Jbp  # noqa: E402
import dopamine_liquid_interaction as Jdl  # noqa: E402
import heuristic_parameter_search as Jhs  # noqa: E402
import lsm_setup as Jlsm  # noqa: E402
import schizophrenia_simulation as Jsz  # noqa: E402
import tolman_eichenbaum as Jtem  # noqa: E402

from spiking_neural_networks_tpu_torch.experiments import (  # noqa: E402
    attractor_manifold as Tam, bayesian_inference_pipeline as Tbp,
    dopamine_liquid_interaction as Tdl, heuristic_parameter_search as Ths,
    lsm_setup as Tlsm, pipeline_setup, schizophrenia_simulation as Tsz,
    tolman_eichenbaum as Ttem)

torch.set_num_threads(1)

# -- lsm_setup -------------------------------------------------------------


def test_lsm_helpers_match_jax():
    for seed in (0, 1):
        np.testing.assert_array_equal(
            Tlsm.generate_liquid_weights(
                25, connectivity=0.3, scalar=0.5,
                rng=np.random.default_rng(seed)),
            Jlsm.generate_liquid_weights(
                25, connectivity=0.3, scalar=0.5,
                rng=np.random.default_rng(seed)))
    v = list(np.random.default_rng(2).normal(-60, 3, 3000))
    # the reference's hard-coded 1000 (off_phase > 1000) and the
    # settling period below it
    for args in ((v, 100, 500, 1200, 2.0), (v[:700], 50, 200, 250, 0.5),
                 (v[:700], 50, 200, 250, 1e-9)):
        assert Tlsm.determine_return_to_baseline(*args) \
            == Jlsm.determine_return_to_baseline(*args)
    assert Tlsm.determine_return_to_baseline(v[:300], 10, 100, 250, 1e-9) \
        == 250

    class N:
        chance_of_firing = 0.3

    assert Tlsm.generate_start_firing(0.02)(N()).chance_of_firing == 0.02
    assert Tlsm.stop_firing(N()).chance_of_firing == 0.0


def test_dopa_liquid_network_built_equal_and_matches_jax(monkeypatch):
    """`build_dopa_liquid_network` (the manifold pipelines' builder): the
    swapped gmax pair kept, the network equal edge for edge, the route of
    both gates, and the cue-free run within 1e-4 mV."""
    rec = tp.Recorder(monkeypatch)
    sp = dict(exc_n=7, inh_n=3, exc_only=False, dt=1.0)
    cs = dict(glutamate_clearance=0.002, gabaa_clearance=0.003,
              nmda_g=0.7, ampa_g=1.1, gabaa_g=1.3,
              inh_to_exc_connectivity=0.3, inh_to_exc_weight=0.02,
              exc_to_inh_connectivity=0.25, exc_to_inh_weight=0.015)

    def build(mod, **device):
        rng = np.random.default_rng(4)
        w = mod.generate_liquid_weights(49, connectivity=0.25, scalar=0.5,
                                        rng=rng)
        w_inh = mod.generate_liquid_weights(9, connectivity=0.25, scalar=2,
                                            rng=rng)
        setup = pipeline_setup.generate_setup_neuron(25, 1, rng=rng)
        net, e1, _, _ = mod.build_dopa_liquid_network(
            sp, cs, w, rng, w_inh=w_inh, setup_neuron=setup, **device)
        net.run_lattices(40)
        return net, e1

    jnet, e1 = run_three(rec, lambda: build(Jlsm),
                         lambda: build(Tlsm, device="cpu"))[0]
    jnet = jnet.inner
    check_routes(rec, "flat-chemical")
    check_runs(rec, (e1,), FREE, upto=40)
    # the swapped pair is assigned to ``ampa_g`` / ``nmda_g``, which are
    # not the receptor's fields (``g_ampa`` / ``g_nmda``): in both packages
    # the lattices keep the default conductances (ROADMAP queue 3)
    for net in (jnet, rec.torch[0][0]):
        state = net.lattices[e1].state
        for k, want in (("g_ampa", 1.0), ("g_nmda", 0.6), ("g_gaba", 1.3)):
            np.testing.assert_allclose(tp._host(state[f"rec${k}"]), want,
                                       rtol=1e-6)


# -- schizophrenia_simulation ----------------------------------------------

SZ_TOML = os.path.join(ROOT, "experiments", "schizophrenia_pipeline_args",
                       "gmax_with_recall_cue.toml")


def sz_inputs(mode):
    """`main`'s inputs of the TOML's first grid point, cut to 150 + 100
    steps; ``FORCED``: the cue's chances are 0 and 1."""
    with open(SZ_TOML, "rb") as f:
        parsed = Tsz.parse_toml(f)
    Tsz.fill_defaults(parsed)
    sp = parsed["simulation_parameters"]
    sp.update(iterations1=150, iterations2=100, first_window=100,
              second_window=80)
    if mode == FORCED:
        sp["cue_firing_rate"] = 1.0
    rng = np.random.default_rng(sp["seed"])
    patterns = Tsz.generate_patterns(sp["exc_n"] ** 2, 0.5,
                                     sp["num_patterns"],
                                     sp["correlation_threshold"], rng=rng)
    cs = {k: parsed["variables"][k][0] for k in Tsz.KEYS}
    return sp, cs, patterns, rng


@pytest.mark.parametrize("mode", [FORCED, FREE])
def test_schizophrenia_trial_matches_jax(monkeypatch, mode):
    rec = tp.Recorder(monkeypatch)
    with np.errstate(divide="ignore", invalid="ignore"):
        jv, kv, pv = run_three(
            rec, lambda: Jsz.run_trial(*sz_inputs(mode)),
            lambda: Tsz.run_trial(*sz_inputs(mode), device="cpu"))
    check_routes(rec, "flat-chemical")
    assert rec.jax_steps == [150, 100]
    check_runs(rec, (Tsz.E1,), mode)
    for v in (kv, pv):
        assert v[1:] == jv[1:]                  # the two patterns
        assert set(v[0]) == set(jv[0])
        if mode == FORCED:
            assert v[0]["peaks"] == jv[0]["peaks"]
            assert v[0]["first_acc"] == jv[0]["first_acc"]
            assert v[0]["second_acc"] == jv[0]["second_acc"]
            assert v[0]["first_snr"] == pytest.approx(jv[0]["first_snr"],
                                                      rel=1e-4)


# -- dopamine_liquid_interaction -------------------------------------------

DL_TOML = os.path.join(ROOT, "experiments", "dopamine_liquid_args",
                       "d1_exc_glu_clearance.toml")
DL_OFF = 120


def dl_inputs(mode):
    with open(DL_TOML, "rb") as f:
        parsed = pipeline_setup.parse_toml(f)
    Tdl.fill_defaults(parsed)
    sp = parsed["simulation_parameters"]
    sp.update(off_phase=DL_OFF, on_phase=60, settling_period=30)
    cs = {k: v[0] for k, v in parsed["variables"].items()}
    if mode == FORCED:
        cs.update(cue_firing_rate=1.0, dopamine_firing_rate=1.0)
    return sp, cs, np.random.default_rng(0)


@pytest.mark.parametrize("mode", [FORCED, FREE])
def test_dopamine_liquid_grid_point_matches_jax(monkeypatch, mode):
    """The TOML's first grid point (tonic dopamine 0 in the free run, so
    no draw can fire before the cue turns on at `DL_OFF`)."""
    rec = tp.Recorder(monkeypatch)
    jv, kv, pv = run_three(
        rec, lambda: Jdl._run_grid_point(*dl_inputs(mode)),
        lambda: Tdl._run_grid_point(*dl_inputs(mode), device="cpu"))
    check_routes(rec, "flat-chemical")
    assert rec.jax_steps == [DL_OFF, 60, DL_OFF]
    check_runs(rec, (0,), mode, upto=DL_OFF)
    for v in (kv, pv):
        assert set(v) == set(jv)
        np.testing.assert_allclose(v["voltages"][:DL_OFF],
                                   jv["voltages"][:DL_OFF], atol=1e-4)
        if mode == FORCED:
            assert v["return_to_baseline"] == jv["return_to_baseline"]
            assert v["peaks"] == jv["peaks"]


def test_dopamine_run_condition_matches_jax(monkeypatch):
    """`run_condition` (the keyword `main`'s protocol) at 5 x 5: equal up
    to the disturbance (the tonic dopamine draws from step 0, its chance
    forced to 0 and 1 in turn)."""
    rec = tp.Recorder(monkeypatch)
    kw = dict(rows=5, cols=5, off_phase=60, on_phase=30, settling_period=20,
              disturb_rate=1.0)
    for dopa_rate in (0.0, 1.0):
        rec.jax.clear(), rec.torch.clear()
        jv, kv, pv = run_three(
            rec, lambda: Jdl.run_condition(1.0, 0.0, dopa_rate=dopa_rate,
                                           **kw),
            lambda: Tdl.run_condition(1.0, 0.0, dopa_rate=dopa_rate, **kw,
                                      device="cpu"))
        check_runs(rec, (0,), FORCED)
        for v in (kv, pv):
            assert v["recovery_steps"] == jv["recovery_steps"]
            assert v["snr_baseline"] == pytest.approx(jv["snr_baseline"],
                                                      rel=1e-3)
    n = len(rec.jax_routes)
    assert rec.jax_routes == ["flat-chemical"] * n
    assert rec.routes() == (["flat-chemical"] * 3 + [False] * 3) * 2


# -- bayesian_inference_pipeline -------------------------------------------


def bp_inputs(mode):
    p = dict(Tbp.DEFAULTS["simulation_parameters"], iterations=200)
    if mode == FORCED:
        p.update(main_firing_rate=1.0, bayesian_firing_rate=1.0)
    rng = np.random.default_rng(p["seed"])
    patterns = Tbp.generate_patterns(p["exc_n"] ** 2, p["p_on"],
                                     p["num_patterns"],
                                     p["correlation_threshold"], rng=rng)
    index = int(rng.integers(0, p["num_patterns"]))
    return p, patterns, index, rng, p["d2"]


@pytest.mark.parametrize("mode", [FORCED, FREE])
def test_bayesian_pipeline_trial_matches_jax(monkeypatch, mode):
    rec = tp.Recorder(monkeypatch)
    jv, kv, pv = run_three(
        rec, lambda: Jbp.run_trial(*bp_inputs(mode)),
        lambda: Tbp.run_trial(*bp_inputs(mode), device="cpu"))
    check_routes(rec, "flat-chemical")
    check_runs(rec, (1,), mode)
    assert len(rec.jax[0][0].spike_train_lattices) == 2
    for v in (kv, pv):
        if mode == FORCED:
            assert v[0] == jv[0]
            np.testing.assert_array_equal(v[1], jv[1])
        else:
            assert BAND(int(v[1].sum()), int(jv[1].sum()))


# -- attractor_manifold ----------------------------------------------------


def am_inputs():
    rng = np.random.default_rng(0)
    patterns = Tam.generate_patterns(49, 0.5, 3, 10.0, rng=rng)
    w = Tam.get_weights(49, patterns, a=0.5, b=0.5, scalar=2.0 / 3)
    w_ie = Tam.weights_ie(3, 0.5, patterns, 3)
    return w, w_ie, patterns, 1, 7, 3, rng


@pytest.mark.parametrize("mode", [FORCED, FREE])
def test_attractor_trial_matches_jax(monkeypatch, mode):
    rec = tp.Recorder(monkeypatch)
    kw = dict(iterations=200, cue_firing_rate=1.0 if mode == FORCED
              else 0.01)
    jv, kv, pv = run_three(
        rec, lambda: Jam.run_trial(*am_inputs(), **kw),
        lambda: Tam.run_trial(*am_inputs(), **kw, device="cpu"))
    check_routes(rec, "flat-chemical")
    check_runs(rec, (1,), mode)
    for v in (kv, pv):
        assert v.shape == jv.shape == (200, 49)
        if mode == FORCED:
            np.testing.assert_allclose(v, jv, atol=2.0)
        else:
            np.testing.assert_allclose(v[:1], jv[:1], atol=1e-4)


# -- tolman_eichenbaum -----------------------------------------------------


def test_tolman_eichenbaum_matches_jax(monkeypatch, tmp_path):
    """`main` at its widths (12 positions, 4 objects), two visits a walk:
    STDP learning runs, then recall runs.  The ring->readout block (12
    cells onto 4, uniform) is a resample connection beside the readout's
    dense graph, so both gates keep every run plain; the runs are
    Rate-driven and agree within 2 mV and 2 steps, histories and
    accuracies alike."""
    rec = tp.Recorder(monkeypatch)
    outputs_to(monkeypatch, tmp_path, Jtem, Ttem)
    kw = dict(n_pos=12, n_obj=4, walk_steps=2, steps_per_visit=16)
    jv, kv, pv = run_three(rec, lambda: Jtem.main(**kw),
                           lambda: Ttem.main(**kw, device="cpu"))
    n = 2 * (2 + 12)
    assert rec.jax_routes == [False] * n
    assert rec.routes() == [False] * 2 * n
    (jnet, jsnap), runs = rec.jax[0], rec.torch
    for tnet, tsnap in runs:
        tp.assert_built_equal(jsnap, tsnap)
        for i in (Ttem.RING, Ttem.READOUT):
            tp.assert_histories_close(jnet.lattices[i], tnet.lattices[i])
        k = tnet.spike_train_lattices[Ttem.CUE].state["refractoriness$k"]
        assert k.dtype == torch.float32 and (k == 2.0).all()
    assert kv == pv == jv


# -- heuristic_parameter_search ---------------------------------------------


@pytest.mark.parametrize("mode", [FORCED, FREE])
def test_heuristic_objective_matches_jax(monkeypatch, mode):
    """The objective's lattice (6 x 6, `connect_stencil(radius=1.5,
    keep_prob=0.8)`) and its Poisson drive take the grid-mode persistent
    network kernel in both gates; the stencil graph is built equal."""
    rec = tp.Recorder(monkeypatch)
    params = dict(drive_rate=1.0 if mode == FORCED else 0.1,
                  drive_weight=1.5)
    jv, kv, pv = run_three(
        rec, lambda: Jhs.firing_rate_objective(params, iterations=200),
        lambda: Ths.firing_rate_objective(params, iterations=200,
                                          device="cpu"))
    check_routes(rec, "network")
    check_runs(rec, (0,), mode)
    if mode == FORCED:
        assert kv == pv == jv
    else:
        assert BAND(kv * 36, jv * 36) and BAND(pv * 36, jv * 36)


def test_heuristic_search_main_matches_jax(monkeypatch, tmp_path):
    """`main`'s search loop on a cheap deterministic objective: the same
    trace and best point in both packages."""
    outputs_to(monkeypatch, tmp_path, Jhs, Ths)

    def objective(params, **kw):
        return 40 * params["drive_rate"] + 3 * params["drive_weight"] ** 2

    monkeypatch.setattr(Jhs, "firing_rate_objective", objective)
    monkeypatch.setattr(Ths, "firing_rate_objective", objective)
    jo = Jhs.main(target=5.0, search_iterations=6)
    to = Ths.main(target=5.0, search_iterations=6, device="cpu")
    assert to == jo and to["n_evaluations"] == 10


def test_heuristic_main_end_to_end(tmp_path, monkeypatch):
    """`main` with its real objective (5 evaluations of 400 steps)."""
    outputs_to(monkeypatch, tmp_path, Ths)
    out = Ths.main(search_iterations=1, device="cpu")
    assert json.loads((tmp_path / "heuristic_search_output.json")
                      .read_text()) == out
    assert out["n_evaluations"] == 5 and out["best_score"] >= 0.0
    assert set(out) == {"target", "best_params", "best_score",
                        "n_evaluations", "trace"}


# -- command lines ----------------------------------------------------------

ARGV_MAINS = [Tsz.main, Tbp.main, Tdl.run_grid]
CLIS = [Tdl.cli, Tam.cli, Ttem.cli, Ths.cli]


@pytest.mark.parametrize("entry", ARGV_MAINS + CLIS,
                         ids=lambda f: f"{f.__module__.rsplit('.', 1)[1]}."
                                       f"{f.__name__}")
def test_device_option_takes_cuda_or_cpu(entry, capsys):
    argvs = ([["prog", "--device", "tpu"], ["prog", "x.toml", "--device"]]
             if entry in ARGV_MAINS else [["--device", "tpu"], ["--device"]])
    for argv in argvs:
        with pytest.raises(SystemExit) as e:
            entry(argv)
        assert e.value.code == 2
    assert "--device" in capsys.readouterr().err


def test_schizophrenia_main_end_to_end(tmp_path, monkeypatch):
    outputs_to(monkeypatch, tmp_path, Tsz)
    toml = tmp_path / "sz.toml"
    toml.write_text(
        "[simulation_parameters]\n"
        "iterations1 = 60\niterations2 = 40\nfirst_window = 40\n"
        "second_window = 30\ntrials = 1\nmeasure_snr = true\n"
        "use_correlation_as_accuracy = true\nfilename = \"sz.json\"\n"
        "[variables]\nnmda_g = [0.6, 0.1]\n")
    with np.errstate(divide="ignore", invalid="ignore"):
        out = Tsz.main(["prog", str(toml), "--device", "cpu"])
    assert len(out) == 2
    assert json.loads((tmp_path / "sz.json").read_text()) == out
    for value in out.values():
        assert set(value) == {"first_acc", "second_acc", "first_snr",
                              "second_snr"}


def test_dopamine_run_grid_end_to_end(tmp_path, monkeypatch):
    outputs_to(monkeypatch, tmp_path, Tdl)
    toml = tmp_path / "dl.toml"
    toml.write_text(
        "[simulation_parameters]\n"
        "off_phase = 60\non_phase = 30\nsettling_period = 20\ntrials = 1\n"
        "exc_only = false\nmeasure_snr = true\nd1 = true\n"
        "filename = \"dl.json\"\n"
        "[variables]\ndopamine_firing_rate = [0.0, 0.01]\n")
    out = Tdl.run_grid(["prog", str(toml), "--device", "cpu"])
    assert len(out) == 2
    assert json.loads((tmp_path / "dl.json").read_text()) == out
    for value in out.values():
        assert set(value) == {"return_to_baseline", "voltages", "first_snr",
                              "second_snr", "during_disturbance"}
        assert len(value["voltages"]) == 150


def test_bayesian_pipeline_main_end_to_end(tmp_path, monkeypatch):
    outputs_to(monkeypatch, tmp_path, Tbp)
    toml = tmp_path / "bp.toml"
    toml.write_text("[simulation_parameters]\niterations = 80\ntrials = 2\n"
                    "filename = \"bp.json\"\n")
    Tbp.main(["prog", str(toml), "--device", "cpu"])
    out = json.loads((tmp_path / "bp.json").read_text())
    assert set(out) == {"parameters", "results"}
    assert [r["trial"] for r in out["results"]] == [0, 1]
    assert set(out["results"][0]) == {"trial", "pattern_index", "accuracy",
                                      "total_spikes", "wall_s"}


def test_attractor_main_end_to_end(tmp_path, monkeypatch):
    outputs_to(monkeypatch, tmp_path, Tam)
    within, between = Tam.main(num_patterns=2, trials=2, iterations=80,
                               firing_data_filename="fd.json", device="cpu")
    out = json.loads((tmp_path / "attractor_manifold_output.json")
                     .read_text())
    assert set(out) == {"embedding", "labels", "within", "between",
                        "explained_variance", "patterns"}
    assert out["within"] == within and len(out["labels"]) == 4
    data = json.loads((tmp_path / "fd.json").read_text())
    assert len(data) == 5 and len(data["patterns"]) == 2


def test_tolman_eichenbaum_cli_passes_its_options(monkeypatch):
    monkeypatch.setattr(Ttem, "main", lambda **kw: kw)
    assert Ttem.cli(["--positions", "5", "--device", "cpu"]) == dict(
        n_pos=5, n_obj=4, walk_steps=60, device="cpu")

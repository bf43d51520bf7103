"""The liquid pipelines of the port's ``experiments/`` against the JAX
package's scripts on the CPU: the digits (``digits``),
``liquid_state_machine``, ``liquid_manifold_generation``,
``training_liquid_pipeline``, ``liquid_manifold_digits`` and the offline
``attractor_manifold_plot``.

* ``digits.load_digits`` equals scikit-learn's, and ``digits.
  train_test_split`` gives scikit-learn's stratified split, index for
  index;
* each pipeline builds its networks from one NumPy seed, edge for edge
  (`torch_pipelines.Recorder`), takes the JAX gate's route run by run and
  runs both its kernel route's twin and its plain route on the CPU;
* a Poisson train draws from a JAX key in one package and a
  `torch.Generator` in the other, so with every chance of firing forced
  to 0 or 1 the runs agree within 2 mV and 2 steps, and in a free run
  within 1e-4 mV before the first draw that can fire and in firing counts
  within `torch_pipelines.BAND` after it;
* the swapped ``ampa_g`` / ``nmda_g`` of ``lsm_setup`` change nothing in
  either package (ROADMAP queue 3);
* ``--device`` takes ``cuda`` or ``cpu`` and nothing else.
"""

import functools
import json
import os
import pickle

import numpy as np
import pytest
import torch

import torch_pipelines as tp
from torch_pipelines import (BAND, FORCED, FREE, ROOT, check_routes,
                             check_runs, outputs_to, run_three)

import attractor_manifold_plot as Jamp  # noqa: E402
import liquid_manifold_digits as Jlmd  # noqa: E402
import liquid_manifold_generation as Jlmg  # noqa: E402
import liquid_state_machine as Jlsm  # noqa: E402
import training_liquid_pipeline as Jtl  # noqa: E402

from spiking_neural_networks_tpu_torch.experiments import (  # noqa: E402
    attractor_manifold_plot as Tamp, digits, liquid_manifold_digits as Tlmd,
    liquid_manifold_generation as Tlmg, liquid_state_machine as Tlsm,
    pipeline_setup, training_liquid_pipeline as Ttl)

torch.set_num_threads(1)

# -- digits -------------------------------------------------------------------


def test_load_digits_equals_scikit_learn():
    sk = pytest.importorskip("sklearn.datasets").load_digits()
    mine = digits.load_digits()
    for key in ("images", "data", "target"):
        a, b = getattr(mine, key), getattr(sk, key)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert mine.images.shape == (1797, 8, 8)


@pytest.mark.parametrize("train_size", [35, 179])
def test_split_equals_scikit_learn(train_size):
    split = pytest.importorskip("sklearn.model_selection").train_test_split
    d = digits.load_digits()
    for seed in range(5):
        want = split(d.data, d.target, train_size=train_size,
                     stratify=d.target, random_state=seed)
        got = digits.train_test_split(d.data, d.target, train_size=train_size,
                                      stratify=d.target, random_state=seed)
        assert len(got) == 4
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert len(got[0]) == train_size


# -- liquid_state_machine ----------------------------------------------------

LSM_STEPS = 120


def lsm_pattern():
    return np.random.default_rng(0).random((10, 10)) < 0.3


@pytest.mark.parametrize("mode", [FORCED, FREE])
def test_liquid_state_machine_build_matches_jax(monkeypatch, mode):
    """One condition of `main`: the 10 x 10 dense liquid and its input
    train (``FORCED``: 1e4 Hz, a chance of 1)."""
    rec = tp.Recorder(monkeypatch)
    rate = 1e4 if mode == FORCED else 80.0

    def run(mod, **device):
        net, liquid = mod.build(2, lsm_pattern(), rate_hz=rate, **device)
        return mod.liquid_state(net, liquid, LSM_STEPS)

    jv, kv, pv = run_three(rec, lambda: run(Jlsm),
                           lambda: run(Tlsm, device="cpu"))
    check_routes(rec, "flat")
    # a train's first spike reaches the liquid one step later
    check_runs(rec, (0,), mode, upto=1)
    for v in (kv, pv):
        if mode == FORCED:
            np.testing.assert_allclose(v, jv, rtol=1e-6)
        else:
            assert BAND(int((v > 0).sum()), int((jv > 0).sum()))


def test_liquid_state_machine_main_matches_jax(monkeypatch):
    """`main`'s four conditions, their trains forced to a chance of 1:
    the same distances."""
    rec = tp.Recorder(monkeypatch)
    for mod in (Jlsm, Tlsm):
        monkeypatch.setattr(mod, "build",
                            functools.partial(mod.build, rate_hz=1e4))
    jv, kv, pv = run_three(rec, lambda: Jlsm.main(iterations=60),
                           lambda: Tlsm.main(iterations=60, device="cpu"))
    assert len(rec.jax) == 4 and len(rec.torch) == 8
    assert rec.jax_routes == ["flat"] * 4
    assert rec.routes() == ["flat"] * 4 + [False] * 4
    for v in (kv, pv):
        np.testing.assert_allclose(v, jv, rtol=1e-5)


# -- liquid_manifold_generation ----------------------------------------------


@pytest.mark.parametrize("mode", [FORCED, FREE])
def test_liquid_manifold_main_matches_jax(monkeypatch, tmp_path, mode):
    """`main` (the `liquid_state_machine` liquid, its left half driven,
    then silent): the output JSON within the tolerances."""
    outputs_to(monkeypatch, tmp_path, Jlmg, Tlmg)
    rec = tp.Recorder(monkeypatch)
    kw = dict(on_phase=80, off_phase=60,
              rate_hz=1e4 if mode == FORCED else 80.0)
    jv, kv, pv = run_three(rec, lambda: Jlmg.main(**kw),
                           lambda: Tlmg.main(**kw, device="cpu"))
    check_routes(rec, "flat")
    check_runs(rec, (0,), mode, upto=1)
    out = json.loads((tmp_path / "liquid_manifold_output.json").read_text())
    assert set(out) == {"voltages", "signal_to_noise", "explained_variance",
                        "embedding"}
    assert len(out["voltages"]) == 140
    if mode == FORCED:
        for v in (kv, pv):
            assert v[0] == pytest.approx(jv[0], rel=1e-3, abs=1e-3)
            np.testing.assert_allclose(v[1], jv[1], rtol=1e-3, atol=1e-4)


LMG_TOML = os.path.join(ROOT, "experiments", "liquid_custom_manifold_args",
                        "input_table_test.toml")


def lmg_inputs(mode, **cs_over):
    """`run_grid`'s first grid point of ``input_table_test.toml`` (its
    phases cut to 60 / 40 / 60 steps); ``FORCED``: the table's chances
    0.01 raised to 1."""
    with open(LMG_TOML, "rb") as f:
        parsed = pipeline_setup.parse_toml(f)
    Tlmg.fill_defaults(parsed)
    sp = parsed["simulation_parameters"]
    sp.update(off_phase=60, on_phase=40, settling_period=20)
    cs = {k: v[0] for k, v in parsed["variables"].items()}
    if mode == FORCED:
        cs["input_table"] = [[1.0 if x else 0.0 for x in row]
                             for row in cs["input_table"]]
    cs.update(cs_over)
    return sp, cs, np.random.default_rng(0)


@pytest.mark.parametrize("mode", [FORCED, FREE])
def test_liquid_custom_point_matches_jax(monkeypatch, mode):
    """`_run_custom_point`: the `lsm_setup` liquid (7 x 7 + 3 x 3) and its
    cue, off / on / off; no draw can fire in the first off phase."""
    rec = tp.Recorder(monkeypatch)
    with np.errstate(divide="ignore", invalid="ignore"):
        jv, kv, pv = run_three(
            rec, lambda: Jlmg._run_custom_point(*lmg_inputs(mode)),
            lambda: Tlmg._run_custom_point(*lmg_inputs(mode), device="cpu"))
    check_routes(rec, "flat-chemical")
    assert rec.jax_steps == [60, 40, 60]
    check_runs(rec, (0,), mode, upto=60)
    for v in (kv, pv):
        assert set(v) == set(jv) == {"return_to_baseline", "voltages",
                                     "first_snr", "second_snr",
                                     "during_disturbance", "peaks"}
        np.testing.assert_allclose(v["voltages"][:60], jv["voltages"][:60],
                                   atol=1e-4)
        if mode == FORCED:
            assert v["peaks"] == jv["peaks"]
            assert v["return_to_baseline"] == jv["return_to_baseline"]


def test_liquid_custom_point_gmax_pair_changes_nothing():
    """The swapped pair (`lsm_setup.build_dopa_liquid_network` writes
    ``ampa_g`` / ``nmda_g``, not the receptor's ``g_ampa`` / ``g_nmda``):
    other values give the same run in both packages (ROADMAP queue 3)."""
    for run in (Jlmg._run_custom_point,
                functools.partial(Tlmg._run_custom_point, device="cpu")):
        with np.errstate(divide="ignore", invalid="ignore"):
            a = run(*lmg_inputs(FORCED))
            b = run(*lmg_inputs(FORCED, ampa_g=7.0, nmda_g=0.05))
        assert a == b


def test_liquid_run_grid_end_to_end(tmp_path, monkeypatch):
    outputs_to(monkeypatch, tmp_path, Tlmg)
    toml = tmp_path / "lmg.toml"
    table = [[0.01 if r < 3 and c < 3 else 0.0 for c in range(7)]
             for r in range(7)]
    toml.write_text(
        "[simulation_parameters]\n"
        "off_phase = 40\non_phase = 20\nsettling_period = 10\ntrials = 2\n"
        "exc_only = false\nmeasure_snr = true\npeaks_on = true\n"
        "filename = \"lmg.json\"\n"
        f"[variables]\ninput_table = [{table!r}]\n")
    with np.errstate(divide="ignore", invalid="ignore"):
        out = Tlmg.run_grid(["prog", str(toml)], device="cpu")
    assert list(out) == ["trial: 0", "trial: 1"]
    assert json.loads((tmp_path / "lmg.json").read_text()) == out
    assert len(out["trial: 0"]["voltages"]) == 100
    assert len(out["trial: 0"]["peaks"]) == 49


# -- training_liquid_pipeline ------------------------------------------------


def binary_rates(image, max_rate):
    """Forced encoding: a chance of 1 where a pixel is above 8, else 0."""
    return (np.asarray(image).reshape(-1) > 8).astype(np.float64)


@pytest.mark.parametrize("mode", [FORCED, FREE])
def test_training_liquid_matches_jax(monkeypatch, mode):
    """`run` at a cut ``smoke.toml`` (2 digits, 2 train, 1 test and 1
    exposure sample a class, 40 steps a sample): the liquids built equal,
    flat mode in both gates and plain during the STDP exposure (no
    dense-edge STDP in either kernel), and the spike-count features of
    every presentation (``FORCED``) equal."""
    rec = tp.Recorder(monkeypatch)
    feats = {Jtl: [], Ttl: []}
    for mod in (Jtl, Ttl):
        present = mod.present

        def keep(*a, _present=present, _mod=mod, **k):
            out = _present(*a, **k)
            feats[_mod].append(np.asarray(out).copy())
            return out

        monkeypatch.setattr(mod, "present", keep)
        if mode == FORCED:
            monkeypatch.setattr(mod, "encode_rates", binary_rates)
    p = dict(Jtl.DEFAULTS, digits=[0, 1], train_per_class=2,
             test_per_class=1, stdp_exposure_per_class=1,
             steps_per_sample=40)
    jv, kv, pv = run_three(rec, lambda: Jtl.run(dict(p)),
                           lambda: Ttl.run(dict(p), "cpu"))
    # without exposure 6 presentations; with it 2 plastic, then 6
    want = ["flat"] * 6 + [False] * 2 + ["flat"] * 6
    assert rec.jax_routes == want
    assert rec.routes() == want + [False] * 14
    assert len(rec.jax) == 2 and len(rec.torch) == 4
    for i, (_, jsnap) in enumerate(rec.jax):
        for _, tsnap in (rec.torch[i], rec.torch[2 + i]):
            tp.assert_built_equal(jsnap, tsnap)
    jf, tf = feats[Jtl], feats[Ttl]
    assert len(jf) == 14 and len(tf) == 28
    for k, v in ((0, kv), (14, pv)):
        assert set(v) == set(jv)
        if mode == FORCED:
            for a, b in zip(tf[k:k + 14], jf):
                np.testing.assert_array_equal(a, b)
            assert v["with_stdp"] == jv["with_stdp"]
            assert v["without_stdp"] == jv["without_stdp"]
        else:
            assert BAND(int(sum(f.sum() for f in tf[k:k + 14])),
                        int(sum(f.sum() for f in jf)))


def test_training_liquid_main_end_to_end(tmp_path, monkeypatch):
    outputs_to(monkeypatch, tmp_path, Ttl)
    toml = tmp_path / "tl.toml"
    toml.write_text("[simulation_parameters]\ndigits = [0, 1]\n"
                    "train_per_class = 2\ntest_per_class = 1\n"
                    "stdp_exposure_per_class = 1\nsteps_per_sample = 30\n"
                    "filename = \"tl.json\"\n")
    out = Ttl.main(["prog", str(toml), "--device", "cpu"])
    assert set(out) == {"without_stdp", "with_stdp", "chance", "parameters"}
    assert json.loads((tmp_path / "tl.json").read_text()) == out
    assert out["chance"] == 0.5


# -- liquid_manifold_digits ----------------------------------------------------

LMD_QUIET = 30
LMD_TOML = os.path.join(ROOT, "experiments", "liquid_mnist_args",
                        "reference_test.toml")


def lmd_inputs(mode, **cs_over):
    """``reference_test.toml`` (7 x 7, exc only) with its phases cut to
    60 / 40 / 60 steps; ``FORCED``: the cue's chance 1."""
    with open(LMD_TOML, "rb") as f:
        parsed = pipeline_setup.parse_toml(f)
    Tlmd.fill_defaults(parsed)
    sp = parsed["simulation_parameters"]
    sp.update(off_phase=60, on_phase=40)
    cs = dict(parsed["variables"])
    if mode == FORCED:
        cs["cue_firing_rate"] = 1.0
    cs.update(cs_over)
    digit = digits.load_digits().data[0]
    return sp, cs, digit, np.random.default_rng(0)


@pytest.mark.parametrize("mode", [FORCED, FREE])
def test_liquid_digit_run_matches_jax(monkeypatch, mode):
    """`run_digit`: no cue is wired before the first off phase ends, so
    the free runs agree within 1e-4 mV until then: over `LMD_QUIET` steps,
    since at step 36 a neuron's upstroke (c_m 25) amplifies the two
    packages' float32 association difference to 1.15e-4 mV (the forced
    runs hold the whole run to 2 mV / 2 steps)."""
    rec = tp.Recorder(monkeypatch)
    with np.errstate(divide="ignore", invalid="ignore"):
        jv, kv, pv = run_three(
            rec, lambda: Jlmd.run_digit(*lmd_inputs(mode)),
            lambda: Tlmd.run_digit(*lmd_inputs(mode), device="cpu"))
    check_routes(rec, "flat-chemical")
    assert rec.jax_steps == [60, 40, 60]
    # the cue is connected after the first run: compare the build of the
    # first run, then the whole trajectory
    (jnet, jsnap), runs = rec.jax[0], rec.torch
    for tnet, tsnap in runs:
        tp.assert_built_equal(jsnap, tsnap)
        assert list(tnet.connections) == list(jnet.connections)
        for key, conn in jnet.connections.items():
            for x, y in zip(conn[:3], tnet.connections[key][:3]):
                np.testing.assert_array_equal(tp._host(y), tp._host(x))
        if mode == FORCED:
            tp.assert_histories_close(jnet.lattices[0], tnet.lattices[0])
        else:
            assert tp.max_dv(jnet.lattices[0], tnet.lattices[0],
                             LMD_QUIET) <= 1e-4
    for v in (kv, pv):
        assert set(v) == {"firing_rates", "peaks", "voltages"}
        np.testing.assert_allclose(v["voltages"][:LMD_QUIET],
                                   jv["voltages"][:LMD_QUIET], atol=1e-4)
        if mode == FORCED:
            assert v["peaks"] == jv["peaks"]
        else:
            assert BAND(sum(v["firing_rates"]), sum(jv["firing_rates"]))


def test_liquid_digit_gmax_pair_changes_nothing():
    for run in (Jlmd.run_digit,
                functools.partial(Tlmd.run_digit, device="cpu")):
        with np.errstate(divide="ignore", invalid="ignore"):
            a = run(*lmd_inputs(FORCED))
            b = run(*lmd_inputs(FORCED, ampa_g=7.0, nmda_g=0.05))
        assert a == b


def test_liquid_digits_main_samples_as_jax(tmp_path, monkeypatch):
    """`main` end to end: the stratified sample of scikit-learn's split
    (the JAX script's) and the same keys, one digit each at 30 / 20 / 30
    steps."""
    pytest.importorskip("sklearn")
    outputs_to(monkeypatch, tmp_path, Jlmd, Tlmd)
    toml = tmp_path / "lmd.toml"
    toml.write_text("[simulation_parameters]\noff_phase = 30\n"
                    "on_phase = 20\nfilename = \"lmd.json\"\n[variables]\n")
    with np.errstate(divide="ignore", invalid="ignore"):
        jout = Jlmd.main(["prog", str(toml)], seed=3, max_digits=2)
        tout = Tlmd.main(["prog", str(toml), "--device", "cpu"], seed=3,
                         max_digits=2)
    assert list(tout) == list(jout) and len(tout) == 2
    assert json.loads((tmp_path / "lmd.json").read_text()) == tout
    for key in tout:
        assert len(tout[key]["voltages"]) == 80


# -- attractor_manifold_plot -------------------------------------------------


def test_attractor_manifold_plot_matches_jax(tmp_path):
    """The copy reduces and plots the firing-data JSON as the JAX
    script does: the same rows, the same embedding, both figures."""
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(1)
    patterns = (rng.random((2, 25)) < 0.5).astype(int).tolist()
    data = {"patterns": patterns}
    for t in range(3):
        for p in range(2):
            data[f"trial: {t}, pattern: {p}, distortion: 0.1"] = {
                "firing_rates": (np.array(patterns[p]) * rng.integers(
                    3, 9, 25) + rng.integers(0, 2, 25)).tolist()}
    firing = tmp_path / "firing.json"
    firing.write_text(json.dumps(data))
    for mod in (Jamp, Tamp):
        a, b = mod.load_firing_data(str(firing)), \
            Jamp.load_firing_data(str(firing))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    rates = Tamp.load_firing_data(str(firing))[4]
    np.testing.assert_array_equal(
        Tamp.PCAReducer().fit_transform(Tamp.standardize(rates)),
        Jamp.PCAReducer().fit_transform(Jamp.standardize(rates)))
    toml = tmp_path / "plot_args.toml"
    toml.write_text(
        '[plot_args]\n'
        f'firing_data = "{firing}"\n'
        'colors = ["red", "blue"]\n'
        'plot_high_accuracy_only_bounded_data = true\n'
        'bounding_percent = 0.5\n'
        f'save_all_data_plot = "{tmp_path / "all.png"}"\n'
        f'save_bounded_plot = "{tmp_path / "bounded.png"}"\n'
        '[reducer_args]\n'
        f'reducer_all_data = "{tmp_path / "reducer.pkl"}"\n')
    Tamp.main(str(toml), show=False)
    assert (tmp_path / "all.png").exists()
    assert (tmp_path / "bounded.png").exists()
    with open(tmp_path / "reducer.pkl", "rb") as f:
        reducer = pickle.load(f)
    assert reducer.transform(Tamp.standardize(rates)).shape == (6, 3)


# -- command lines ----------------------------------------------------------

ARGV_MAINS = [Ttl.main, Tlmd.main]
CLIS = [Tlsm.cli, Tlmg.cli]


@pytest.mark.parametrize("entry", ARGV_MAINS + CLIS,
                         ids=lambda f: f"{f.__module__.rsplit('.', 1)[1]}."
                                       f"{f.__name__}")
def test_device_option_takes_cuda_or_cpu(entry, capsys):
    argvs = ([["prog", "x.toml", "--device", "tpu"],
              ["prog", "x.toml", "--device"]]
             if entry in ARGV_MAINS else [["--device", "tpu"], ["--device"]])
    for argv in argvs:
        with pytest.raises(SystemExit) as e:
            entry(argv)
        assert e.value.code == 2
    assert "--device" in capsys.readouterr().err


def test_liquid_cli_passes_its_device(monkeypatch):
    monkeypatch.setattr(Tlsm, "main", lambda **kw: kw)
    assert Tlsm.cli(["--device", "cpu"]) == {"device": "cpu"}
    calls = []
    monkeypatch.setattr(Tlmg, "main", lambda **kw: calls.append(kw))
    monkeypatch.setattr(Tlmg, "run_grid",
                        lambda argv, **kw: calls.append((argv[1], kw)))
    Tlmg.cli(["--device", "cpu"])
    Tlmg.cli(["a.toml"])
    assert calls == [{"device": "cpu"}, ("a.toml", {"device": "cuda"})]

"""The spatial pipelines of the port's ``experiments/`` against the JAX
package's scripts on the CPU: the grid cells (``grid_cell_electrochemical``,
``grid_cell_model``), the isolated liquid (``isolated_liquid_pipeline``)
and the head-direction rings (``hd_electrochemical_model_dopaminergic``,
``hd_electrochemical_model``, ``hd_electrochemical_model_no_turning``,
``hd_with_basin``, ``hd_attractor``).

As in ``tests/test_torch_experiments_memory.py``: each network built equal
edge for edge from one NumPy seed; both gates on the same route, run by
run, with the port's kernel route (the twin, ``use_kernel=True``) and its
plain route both run; the Rate-driven runs within 2 mV and 2 steps of the
JAX run and their outputs alike; the Poisson-driven liquid within 1e-4 mV
until its cue turns on, within 2 mV and 2 steps with the cue's chance
forced to 1, its free run's firing counts within `BAND`; ``--device``; each
`main` end to end into ``tmp_path``.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_pipelines as tp
from torch_pipelines import (BAND, FORCED, FREE, ROOT, check_runs, outputs_to,
                             run_three)

import grid_cell_electrochemical as Jgce  # noqa: E402
import grid_cell_model as Jgc  # noqa: E402
import hd_attractor as Jha  # noqa: E402
import hd_electrochemical_model as Jhd  # noqa: E402
import hd_electrochemical_model_dopaminergic as Jhdd  # noqa: E402
import hd_electrochemical_model_no_turning as Jnt  # noqa: E402
import hd_with_basin as Jhb  # noqa: E402
import isolated_liquid_pipeline as Jiso  # noqa: E402

from spiking_neural_networks_tpu_torch.experiments import (  # noqa: E402
    grid_cell_electrochemical as Tgce, grid_cell_model as Tgc,
    hd_attractor as Tha, hd_electrochemical_model as Thd,
    hd_electrochemical_model_dopaminergic as Thdd,
    hd_electrochemical_model_no_turning as Tnt, hd_with_basin as Thb,
    isolated_liquid_pipeline as Tiso)

torch.set_num_threads(1)


def check_rate_runs(rec, want, n_runs):
    """Both gates took ``want`` on each of ``n_runs`` runs (the port's
    plain runs the plain route); built equal; every lattice with a grid
    history within 2 mV and 2 steps of the JAX run, its state finite."""
    assert rec.jax_routes == [want] * n_runs
    assert rec.routes() == [want] * n_runs + [False] * n_runs
    (jnet, jsnap), runs = rec.jax[0], rec.torch
    assert len(runs) == 2
    for tnet, tsnap in runs:
        tp.assert_built_equal(jsnap, tsnap)
        hist = [i for i, lat in jnet.lattices.items()
                if lat.update_grid_history]
        assert hist
        for i in hist:
            tp.assert_histories_close(jnet.lattices[i], tnet.lattices[i])
        for lat in tnet.lattices.values():
            for v in lat.state.values():
                if v.is_floating_point():
                    assert torch.isfinite(v).all()
    return jnet


# -- grid cells -------------------------------------------------------------


def test_grid_cell_electrochemical_matches_jax(monkeypatch, tmp_path):
    """16 x 16 excitatory sheet (dense toroidal weights) + 16 x 16 GABA
    sheet, setter Rate trains: flat chemical in both gates."""
    rec = tp.Recorder(monkeypatch)
    outputs_to(monkeypatch, tmp_path, Jgce, Tgce)
    jv, kv, pv = run_three(rec, lambda: Jgce.main(iterations=160),
                           lambda: Tgce.main(iterations=160, device="cpu"))
    check_rate_runs(rec, "flat-chemical", 1)
    assert kv == pv == jv and kv["total_spikes"] > 0
    assert json.loads((tmp_path / "grid_cell_electrochemical_output.json")
                      .read_text()) == pv


def test_grid_cell_model_matches_jax(monkeypatch):
    """20 x 20 electrical sheet with a dense toroidal graph: flat
    electrical in both gates."""
    rec = tp.Recorder(monkeypatch)
    jv, kv, pv = run_three(rec, lambda: Jgc.main(iterations=100),
                           lambda: Tgc.main(iterations=100, device="cpu"))
    check_rate_runs(rec, "flat", 1)
    assert kv == pv == jv


# -- isolated liquid ---------------------------------------------------------

ISO_ARGS = os.path.join(ROOT, "experiments", "isolated_liquid_args")
# (toml, off / on / settling phases, both gates' route): smoke.toml's 4 x 4
# liquid and 3 x 3 pool join by random blocks narrower than flat mode's
# dense blocks (resample), so both gates keep it plain; glu_clearance.toml's
# 7 x 7 liquid alone takes flat chemical
ISO_CASES = [("smoke.toml", (150, 60, 50), False),
             ("glu_clearance.toml", (100, 50, 20), "flat-chemical")]


def iso_inputs(toml, phases, mode):
    with open(os.path.join(ISO_ARGS, toml), "rb") as f:
        parsed = Tiso.parse_toml(f)
    Tiso.fill_defaults(parsed)
    sp = parsed["simulation_parameters"]
    sp.update(off_phase=phases[0], on_phase=phases[1],
              settling_period=phases[2], peaks_on=True)
    cs = {k: v[0] for k, v in parsed["variables"].items()}
    if mode == FORCED:
        cs["cue_firing_rate"] = 1.0
    return sp, cs, np.random.default_rng(sp["seed"])


@pytest.mark.parametrize("mode", [FORCED, FREE])
@pytest.mark.parametrize("toml, phases, route", ISO_CASES,
                         ids=[c[0] for c in ISO_CASES])
def test_isolated_liquid_trial_matches_jax(monkeypatch, toml, phases, route,
                                           mode):
    rec = tp.Recorder(monkeypatch)
    with np.errstate(divide="ignore", invalid="ignore"):
        jv, kv, pv = run_three(
            rec, lambda: Jiso.run_trial(*iso_inputs(toml, phases, mode)),
            lambda: Tiso.run_trial(*iso_inputs(toml, phases, mode),
                                   device="cpu"))
    off = phases[0]
    assert rec.jax_routes == [route] * 3
    assert rec.routes() == [route] * 3 + [False] * 3
    check_runs(rec, (0,), mode, upto=off)
    for v in (kv, pv):
        assert set(v) == set(jv)
        np.testing.assert_allclose(v["voltages"][:off], jv["voltages"][:off],
                                   atol=1e-4)
        if mode == FORCED:
            assert v["return_to_baseline"] == jv["return_to_baseline"]
            assert v["peaks"] == jv["peaks"]
        else:
            assert BAND(sum(map(len, v["peaks"])),
                        sum(map(len, jv["peaks"])))


def test_isolated_liquid_main_end_to_end(tmp_path, monkeypatch):
    outputs_to(monkeypatch, tmp_path, Tiso)
    toml = tmp_path / "iso.toml"
    toml.write_text(
        "[simulation_parameters]\n"
        "off_phase = 80\non_phase = 40\nsettling_period = 20\ntrials = 1\n"
        "exc_only = false\nexc_n = 4\nmeasure_snr = true\n"
        "filename = \"iso.json\"\n"
        "[variables]\nglutamate_clearance = [0.001, 0.01]\n")
    with np.errstate(divide="ignore", invalid="ignore"):
        out = Tiso.main(["prog", str(toml), "--device", "cpu"])
    assert len(out) == 2
    assert json.loads((tmp_path / "iso.json").read_text()) == out
    for value in out.values():
        assert set(value) == {"return_to_baseline", "voltages", "first_snr",
                              "second_snr", "during_disturbance"}
        assert len(value["voltages"]) == 200


# -- head direction ----------------------------------------------------------


def test_hd_dopaminergic_matches_jax(monkeypatch, tmp_path):
    """Six 60-cell rings and two Rate trains, two runs (the dopamine
    projections at 0, then at their strength): both gates plain (the
    two-cell turning train's all-to-all block onto a ring is a resample
    connection)."""
    rec = tp.Recorder(monkeypatch)
    outputs_to(monkeypatch, tmp_path, Jhdd, Thdd)
    jv, kv, pv = run_three(rec, lambda: Jhdd.main(iterations=100),
                           lambda: Thdd.main(iterations=100, device="cpu"))
    jnet = check_rate_runs(rec, False, 2)
    assert len(jnet.lattices) == 6 and len(jnet.spike_train_lattices) == 2
    assert kv == pv == jv
    assert sum(map(len, pv["peaks"])) > 0
    assert set(json.loads((tmp_path / "hd_dopaminergic_output.json")
                          .read_text())) == {"peaks", "thetas", "parameters"}


def test_hd_electrochemical_matches_jax(monkeypatch, tmp_path):
    rec = tp.Recorder(monkeypatch)
    outputs_to(monkeypatch, tmp_path, Jhd, Thd)
    jv, kv, pv = run_three(rec, lambda: Jhd.main(iterations=150),
                           lambda: Thd.main(iterations=150, device="cpu"))
    check_rate_runs(rec, False, 1)
    assert kv == pv == jv


def test_hd_no_turning_matches_jax(monkeypatch, tmp_path):
    """The ring and its inhibitory partner (dense graphs, dense blocks)
    with a one-to-one cue: flat chemical in both gates, both runs."""
    rec = tp.Recorder(monkeypatch)
    outputs_to(monkeypatch, tmp_path, Jnt, Tnt)
    kw = dict(iterations=100, cue_iterations=100)
    jv, kv, pv = run_three(rec, lambda: Jnt.main(**kw),
                           lambda: Tnt.main(**kw, device="cpu"))
    check_rate_runs(rec, "flat-chemical", 2)
    assert kv == pv == jv


def test_hd_with_basin_matches_jax(monkeypatch, tmp_path):
    """The per-neuron D1 / D2 gains written as tensors on the lattice's
    device; the single dopamine cell's all-to-all block is a resample
    connection: plain in both gates."""
    rec = tp.Recorder(monkeypatch)
    outputs_to(monkeypatch, tmp_path, Jhb, Thb)
    kw = dict(iterations=100, cue_iterations=100)
    jv, kv, pv = run_three(rec, lambda: Jhb.main(**kw),
                           lambda: Thb.main(**kw, device="cpu"))
    check_rate_runs(rec, False, 2)
    assert kv == pv == jv
    for tnet, _ in rec.torch:
        d1 = tnet.lattices[Thb.HD].state["rec$s_d1"]
        assert d1.dtype == torch.float32 and d1.device.type == "cpu"


def test_hd_attractor_matches_jax(monkeypatch):
    """Electrical rings with shift layers: plain in both gates (the
    two-cell turning train's block is a resample connection)."""
    rec = tp.Recorder(monkeypatch)
    jv, kv, pv = run_three(rec, lambda: Jha.main(iterations=300),
                           lambda: Tha.main(iterations=300, device="cpu"))
    check_rate_runs(rec, False, 1)
    assert kv == pv == jv and any(p is not None for p in pv)


# -- command lines ------------------------------------------------------------

CLIS = [Tgce.cli, Tgc.cli, Thdd.cli, Thd.cli, Tnt.cli, Thb.cli, Tha.cli]


@pytest.mark.parametrize("entry", [Tiso.main] + CLIS,
                         ids=lambda f: f"{f.__module__.rsplit('.', 1)[1]}."
                                       f"{f.__name__}")
def test_device_option_takes_cuda_or_cpu(entry, capsys):
    argvs = ([["prog", "--device", "tpu"], ["prog", "x.toml", "--device"]]
             if entry is Tiso.main else [["--device", "tpu"], ["--device"]])
    for argv in argvs:
        with pytest.raises(SystemExit) as e:
            entry(argv)
        assert e.value.code == 2
    assert "--device" in capsys.readouterr().err


def test_clis_pass_their_options(monkeypatch):
    for mod, argv, want in (
            (Tgce, ["--iterations", "7", "--device", "cpu"],
             dict(iterations=7, device="cpu")),
            (Thdd, ["-i", "5", "-d", "0.5"],
             dict(iterations=5, dopamine=0.5, turning=10.0, out_file=None,
                  device="cuda")),
            (Thb, ["--basin", "30", "--device", "cpu"],
             dict(basin=30, cue_angle=20, iterations=4000,
                  cue_iterations=1500, device="cpu"))):
        monkeypatch.setattr(mod, "main", lambda **kw: kw)
        assert mod.cli(argv) == want

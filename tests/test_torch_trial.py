"""The Bayesian-inference trial on the port's `lixirnet`
(``spiking_neural_networks_tpu_torch/experiments/``) against the JAX
package's pipeline (``experiments/bayesian_inference_rate_based.py``) on
the CPU.

* ``smoke.toml``'s trial, cut to 300 steps (``first_window`` 100), through
  both `run_trial`s from the same NumPy seeds: the networks are captured
  by patching `generate_network` (so `run_trial` keeps the JAX
  signature) and built equal, edge for edge; the excitatory lattice's
  grid histories agree within 2 mV at every step (firing times within 2
  steps), on the port's plain route and on its flat-mode kernel route
  (the twin); the value dicts are equal.
* ``smoke_mbm_d2.toml``'s memory-biases-memory network (five lattices, two
  cue trains) is built equal, edge for edge, and its trial agrees as
  above.
* Both trials' networks take the flat-mode persistent kernel: the port's
  gate (`plain_network_spec`, `uses_persistent` and the ``NP_MAX_*``
  limits) and the JAX package's flat-mode gate take them alike.
* `trial_inputs` against what both `main`s hand `run_trial`; `main`'s
  ``--device`` check; `main` through the ``python -m`` entry, and
  `output_path`.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "experiments"))

import bayesian_inference_rate_based as J  # noqa: E402

from spiking_neural_networks_tpu_torch.core.network import \
    LatticeNetwork  # noqa: E402
from spiking_neural_networks_tpu_torch.core.structured import (  # noqa: E402
    nt_flags, resolve_structured_plan)
from spiking_neural_networks_tpu_torch.experiments import (  # noqa: E402
    bayesian_inference_rate_based as T, pipeline_setup)
from spiking_neural_networks_tpu_torch.ops import \
    network_kernels as nk  # noqa: E402

torch.set_num_threads(1)

ARGS = os.path.join(ROOT, "experiments", "bayesian_inf_args")
STEPS, WINDOW = 300, 100


def trial_inputs(toml):
    """``(sp, cs, patterns, bayes_patterns, rng)`` of the first trial of
    ``toml`` as ``main`` makes them (the port's `trial_inputs`, which
    `test_trial_inputs_are_what_main_runs` holds to both `main`s), cut to
    `STEPS`."""
    with open(os.path.join(ARGS, toml), "rb") as f:
        parsed = T.parse_toml(f)
    T.fill_defaults(parsed)
    cs, _, patterns, bayes, rng = next(T.trial_inputs(parsed))
    sp = parsed["simulation_parameters"]
    sp["iterations1"], sp["first_window"] = STEPS, WINDOW
    return sp, cs, patterns, bayes, rng


def captured(monkeypatch, mod):
    """Patch ``mod``'s `generate_network` to keep each network it builds."""
    nets = []
    cls = mod.ln.IzhikevichNeuronNetwork
    orig = cls.generate_network.__func__

    def generate(c, *a, **k):
        net = orig(c, *a, **k)
        # the lattices' voltages as built (run_trial then runs them)
        net.v0 = {i: np.array(lat.state["v"]) for i, lat in
                  net.inner.lattices.items()}
        nets.append(net)
        return net

    monkeypatch.setattr(cls, "generate_network", classmethod(generate))
    return nets


def run_both(monkeypatch, toml, use_kernel=None):
    jn, tn = captured(monkeypatch, J), captured(monkeypatch, T)
    jv = J.run_trial(*trial_inputs(toml))
    if use_kernel is not None:
        run = LatticeNetwork.run_lattices

        def forced(self, n):
            self.use_kernel = use_kernel
            return run(self, n)

        monkeypatch.setattr(LatticeNetwork, "run_lattices", forced)
    tv = T.run_trial(*trial_inputs(toml), device="cpu")
    return jv, tv, jn[0], tn[0]


def assert_built_equal(jnet, tnet):
    ji, ti = jnet.inner, tnet.inner
    assert sorted(ji.lattices) == sorted(ti.lattices)
    assert sorted(ji.spike_train_lattices) == sorted(ti.spike_train_lattices)
    assert list(ji.connections) == list(ti.connections)
    for key, (s, d, w) in ji.connections.items():
        ts, td, tw = ti.connections[key]
        np.testing.assert_array_equal(ts, s, err_msg=str(key))
        np.testing.assert_array_equal(td, d, err_msg=str(key))
        np.testing.assert_array_equal(tw, w, err_msg=str(key))
    for i, lat in ji.lattices.items():
        np.testing.assert_array_equal(tnet.get_lattice(i).weights,
                                      np.asarray(jnet.get_lattice(i).weights))
    for i, st in ji.spike_train_lattices.items():
        for k in ("rate", "step"):
            np.testing.assert_array_equal(
                ti.spike_train_lattices[i].state[k].numpy(),
                np.asarray(st.state[k]), err_msg=k)
    assert list(jnet.v0) == list(tnet.v0)
    for i, v in jnet.v0.items():
        np.testing.assert_array_equal(tnet.v0[i], v, err_msg=f"v of {i}")
    for i, lat in ji.lattices.items():
        for k in ("c_m", "rec$s_d1", "rec$s_d2", "nt$mask"):
            np.testing.assert_array_equal(
                np.asarray(ti.lattices[i].state[k]),
                np.asarray(lat.state[k]), err_msg=k)


def assert_histories_close(jnet, tnet, ids):
    for i in ids:
        hj = np.stack(jnet.get_lattice(i).history)
        ht = np.stack(tnet.get_lattice(i).history)
        assert ht.shape == hj.shape == (STEPS, 7, 7)
        assert np.isfinite(ht).all()
        assert np.abs(hj - ht).max() <= 2.0, float(np.abs(hj - ht).max())
        lj = np.asarray(jnet.get_lattice(i).inner.state["last_firing_time"])
        lt = tnet.get_lattice(i).inner.state["last_firing_time"].numpy()
        assert ((lj < 0) == (lt < 0)).all()
        assert np.abs(lj.astype(np.int64) - lt).max(initial=0) <= 2


@pytest.mark.parametrize("use_kernel", [None, True])
def test_smoke_trial_matches_jax(monkeypatch, use_kernel):
    jv, tv, jnet, tnet = run_both(monkeypatch, "smoke.toml", use_kernel)
    assert tv == jv
    assert_built_equal(jnet, tnet)
    assert_histories_close(jnet, tnet, (T.E1,))
    want = ("flat-chemical", True) if use_kernel else False
    assert tnet.inner._last_run_fused == want
    assert (tnet.get_lattice(T.E1).inner.state["last_firing_time"]
            >= 0).any()


def test_mbm_trial_built_equal_and_matches_jax(monkeypatch):
    jv, tv, jnet, tnet = run_both(monkeypatch, "smoke_mbm_d2.toml", True)
    assert tv == jv
    assert_built_equal(jnet, tnet)
    assert len(tnet.inner.lattices) == 5
    assert len(tnet.inner.spike_train_lattices) == 2
    assert_histories_close(jnet, tnet, (T.E1, T.E2))
    assert tnet.inner._last_run_fused == ("flat-chemical", True)


@pytest.mark.parametrize("toml", ["smoke.toml", "smoke_mbm_d2.toml"])
def test_trial_networks_take_the_persistent_flat_kernel(monkeypatch, toml):
    """The port's gate takes the trial's network in flat mode, within the
    persistent kernel's limits, as the JAX package's flat-mode gate
    (`pallas_reward.plain_network_runner`) does."""
    from spiking_neural_networks_tpu.core import structured as jst
    from spiking_neural_networks_tpu.ops import pallas_reward as jpr

    steps = []
    monkeypatch.setattr(J.ln.IzhikevichNeuronNetwork, "run_lattices",
                        lambda self, n: steps.append(n))
    monkeypatch.setattr(T.ln.IzhikevichNeuronNetwork, "run_lattices",
                        lambda self, n: steps.append(n))
    jn, tn = captured(monkeypatch, J), captured(monkeypatch, T)
    for mod in (J, T):
        sp, cs, patterns, bayes, rng = trial_inputs(toml)
        try:
            mod.run_trial(sp, cs, patterns, bayes, rng,
                          **({"device": "cpu"} if mod is T else {}))
        except ValueError:
            pass        # the empty history a patched run leaves
    jnet, tnet = jn[0].inner, tn[0].inner
    assert steps == [STEPS, STEPS]

    plan = resolve_structured_plan(tnet)
    flags = nt_flags(tnet, plan)
    n_lat = len(plan["lat_ids"])
    spec = nk.plain_network_spec(tnet, plan, not any(flags), flags[n_lat:])
    assert spec is not None and nk.is_flat(spec) and spec.chem
    assert len(spec.lattices) <= nk.NP_MAX_LAT
    assert len(spec.trains) <= nk.NP_MAX_TR
    assert len(spec.conns) <= nk.NP_MAX_CN
    assert nk.uses_persistent(spec)
    assert all(cs.op[0] in ("dense", "one2one") for cs in spec.conns)

    # the JAX gate on the JAX network, with the grid histories its run
    # carries (the two networks hold the same neurotransmitter flags)
    jplan = jst.resolve_structured_plan(jnet)
    assert jplan["lat_ids"] == plan["lat_ids"]
    hist = tuple((i, jnet.lattices[i].grid_history.kind,
                  jst._freeze(jnet.lattices[i].grid_history),
                  (jnet.lattices[i].rows, jnet.lattices[i].cols))
                 for i in jplan["lat_ids"]
                 if jnet.lattices[i].update_grid_history)
    assert hist
    runner = jpr.plain_network_runner(
        jnet, jplan, not any(flags), 16, hist=hist,
        st_nt=tuple(bool(f) for f in flags[n_lat:]))
    assert runner is not None


@pytest.mark.parametrize("toml", ["smoke.toml", "smoke_mbm_d2.toml"])
def test_trial_inputs_are_what_main_runs(tmp_path, monkeypatch, toml):
    """Both `main`s (the JAX package's and the port's) hand `run_trial`,
    trial by trial, what the port's `trial_inputs` gives: the filled
    parameters, the combination, both pattern sets and the generator's
    state."""
    def recorded(mod):
        calls = []

        def run_trial(sp, cs, patterns, bayes, rng, *device):
            calls.append((dict(sp), dict(cs), np.array(patterns),
                          np.array(bayes), rng.bit_generator.state))
            return {"first_acc": 0.0}, 0, 0

        monkeypatch.setattr(mod, "run_trial", run_trial)
        monkeypatch.setattr(mod, "output_path",
                            lambda name: str(tmp_path / name))
        return calls

    jc, tc = recorded(J), recorded(T)
    path = os.path.join(ARGS, toml)
    J.main(["prog", path])
    T.main(["prog", path, "--device", "cpu"])
    with open(path, "rb") as f:
        parsed = T.parse_toml(f)
    T.fill_defaults(parsed)
    want = [(dict(parsed["simulation_parameters"]), dict(cs),
             np.array(patterns), np.array(bayes), rng.bit_generator.state)
            for cs, _, patterns, bayes, rng in T.trial_inputs(parsed)]
    assert len(jc) == len(tc) == len(want) >= 1
    for got in (jc, tc):
        for (sp, cs, p, b, st), (wsp, wcs, wp, wb, wst) in zip(got, want):
            assert sp == wsp and cs == wcs and st == wst
            np.testing.assert_array_equal(p, wp)
            np.testing.assert_array_equal(b, wb)


def test_main_rejects_an_unknown_device(capsys):
    for argv in (["prog", "--device"], ["prog", "--device", "tpu"]):
        with pytest.raises(SystemExit):
            T.main(argv)
    assert "--device" in capsys.readouterr().err


def test_main_runs_a_toml_and_writes_its_output(tmp_path, monkeypatch):
    toml = tmp_path / "tiny.toml"
    out = tmp_path / "tiny.json"
    toml.write_text(
        "[simulation_parameters]\n"
        "iterations1 = 120\nfirst_window = 60\ntrials = 1\nd1 = true\n"
        "use_correlation_as_accuracy = true\n"
        f'filename = "{out}"\n'
        "[variables]\ns_d1 = [1]\ndistortion = [0.2]\n")
    result = T.main(["prog", str(toml), "--device", "cpu"])
    assert len(result) == 1
    assert json.loads(out.read_text()) == result
    value = next(iter(result.values()))
    assert set(value) == {"first_acc", "bayesian_first_acc"}


def test_output_path_is_the_repo_roots_outputs():
    path = pipeline_setup.output_path("x.json")
    assert path == os.path.join(ROOT, "outputs", "x.json")
    assert pipeline_setup.output_path("/abs/y.json") == "/abs/y.json"

"""BENCHMARK.json's format and limits, and cells found from
files by name."""

import json
import os
import re

import pytest

from conftest import BENCH, ROOT, run_cell, tiny_catalog

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_entries_have_just_their_keys_and_valid_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
        for e in SPEC[group]:
            assert set(e) - {"workloads"} == want, (group, e["name"])
            assert NAME.match(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
            texts = [e[k] for k in ("why", "layer") if k in e]
            if group == "configs":
                texts.append(e["source"])
            for t in texts:
                assert 1 <= len(t) <= 200 and not set(t) & {"\n", "\t"}
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_every_cell_reports_enough():
    for cell in CELLS:
        e2e = [m["name"] for m in SPEC["end_to_end"]
               if cell in m.get("workloads", CELLS)]
        layer = [m for m in SPEC["per_layer"]
                 if cell in m.get("workloads", CELLS)]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)


def test_cells_one_chip_and_configs_used():
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(CELLS)
    assert all(w["chips"] == 1 for w in SPEC["workloads"])
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("benchmark/") and os.path.exists(
            os.path.join(ROOT, f))


@pytest.mark.parametrize("cell", CELLS)
def test_cells_resolve_from_files_by_name(cell):
    from snnbench import catalog
    c = catalog.Catalog().cell(cell)
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert c.config["name"] == w["config"]
    assert c.traffic["name"] == w["traffic"]
    assert c.trial is getattr(c.reference, c.traffic["kind"])
    assert callable(c.kind.Runner) and callable(c.kind.inputs)
    assert callable(c.kind.call_least)
    want = [m["name"] for g in ("end_to_end", "per_layer") for m in SPEC[g]
            if cell in m.get("workloads", CELLS)]
    assert [m.name for m in c.metrics] == want
    assert all(callable(m.read) for m in c.metrics)
    assert set(c.config["limits"]) | set(c.traffic.get("limits", {}))


def test_split_metrics_read_with_their_quantity():
    from snnbench import catalog
    cat = catalog.Catalog()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        if "." in m["name"]:
            base = m["name"].rsplit(".", 1)[0]
            assert cat.reader(m["name"]) is cat.reader(base)


def test_run_names_no_cell():
    """Neither the command nor the harness's library names a cell, a
    configuration, a traffic mix, a traffic kind or a system."""
    text = open(os.path.join(BENCH, "run.py")).read()
    for f in os.listdir(os.path.join(BENCH, "snnbench")):
        if f.endswith(".py"):
            text += open(os.path.join(BENCH, "snnbench", f)).read()
    from snnbench import catalog
    cat = catalog.Catalog()
    kinds = {cat.traffic(w["traffic"])["kind"] for w in SPEC["workloads"]}
    for name in CELLS + [c["name"] for c in SPEC["configs"]] + [
            w["traffic"] for w in SPEC["workloads"]] + sorted(kinds):
        assert name not in text, name
    # the system is the configuration's, and only drivers of its entries
    # (`requests`) build it
    for f in ("catalog.py", "check.py", "counts.py", "session.py"):
        src = open(os.path.join(BENCH, "snnbench", f)).read()
        assert "RewardModulatedLattice" not in src, f


def test_a_cell_added_as_files_runs_without_edits(tmp_path):
    """A throwaway configuration, traffic mix, traffic kind, reference and
    metric, added as files in a temporary directory, run through the
    harness as it is.  The kind serves each request as two
    ``run_lattice`` calls of half the steps; its reference is a new file
    with a function of the kind's name."""
    cfg = json.load(open(os.path.join(BENCH, "configs", "izh_stencil.json")))
    cfg.update(name="t_config", graph=dict(cfg["graph"], radius=1.0,
                                           keep=0.5), reference="t_ref")
    extra = {"name": "t_metric", "unit": "count", "better": "higher",
             "source": "program_counter", "layer": "test",
             "moves": "neuron_updates_per_s"}
    cat = tiny_catalog(tmp_path, [extra])
    (tmp_path / "configs" / "t_config.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "t_mix.json").write_text(json.dumps(
        {"kind": "t_halves", "rows": 12, "cols": 20, "steps": 24,
         "v0": [-60.0, 25.0], "check_requests": 2, "trace_requests": 1}))
    (tmp_path / "traffic" / "kinds" / "t_halves.py").write_text(
        "from snnbench import counts, inputs as _inputs, requests\n"
        "class Runner(requests.LatticeRun):\n"
        "    def _call(self):\n"
        "        self.lat.run_lattice(self.steps // 2)\n"
        "        self.lat.run_lattice(self.steps - self.steps // 2)\n"
        "def inputs(cfg, traffic, seed, device):\n"
        "    return _inputs.lattice_inputs(cfg, traffic, seed, device)\n"
        "def call_least(cfg, traffic, graph):\n"
        "    return counts.stencil_call_least(*graph.shape, graph.offsets)\n")
    ref = open(os.path.join(BENCH, "reference", "izhikevich_lattice.py"))
    (tmp_path / "reference" / "t_ref.py").write_text(
        ref.read() + "\n\ndef t_halves(cfg, traffic, graph, v0, "
        "dtype=torch.float32):\n"
        "    return lattice_run(cfg, traffic, graph, v0, dtype)\n")
    (tmp_path / "metrics" / "t_metric.py").write_text(
        "def read(ctx):\n    return float(ctx.window['requests'])\n")
    cat.spec["workloads"].append({"name": "t_cell", "config": "t_config",
                                  "traffic": "t_mix", "chips": 1,
                                  "why": "t"})
    cell = cat.cell("t_cell")
    assert cell.config["graph"]["keep"] == 0.5
    assert cell.kind.__file__ == str(tmp_path / "traffic" / "kinds"
                                     / "t_halves.py")
    e2e = run_cell(cat, "t_cell")
    assert e2e["correct"] and set(e2e["metrics"]) == {
        "neuron_updates_per_s", "request_ms_p95", "setup_s"}
    traced = run_cell(cat, "t_cell", trace=True)
    assert traced["correct"]
    assert traced["metrics"]["t_metric"]["value"] == traced["attempted"]
    assert traced["metrics"]["step_mfu"]["value"] > 0


T_STATE_KIND = '''\
import torch
from snnbench import counts, inputs as _inputs, requests


class Runner(requests.RewardRun):
    """R-STDP requests whose snapshot is a (rows, cols, 3) plane of each
    neuron's v, u and last firing time, the firing times and the weights,
    and nothing else."""

    def snapshot(self):
        s = super().snapshot()
        return {"t$state": torch.stack(
                    (s["v"], s["w"], s["lft"].to(s["v"].dtype)), -1),
                "lft": s["lft"], "weights": s["weights"]}


inputs = _inputs.lattice_inputs


def call_least(cfg, traffic, graph):
    return counts.lp_call_least(*graph.shape, graph.offsets,
                                graph.masked_slots)
'''

T_STATE_REF = '''

_MOVE = [0.0]


def t_state(cfg, traffic, graph, v0, dtype=torch.float32):
    out = reward_run(cfg, traffic, graph, v0, dtype)
    fired = out["lft"].to(out["v"].dtype) + _MOVE[0]
    return {"t$state": torch.stack((out["v"], out["w"], fired), -1),
            "lft": out["lft"], "weights": out["weights"]}


@contextlib.contextmanager
def third_entry():
    """The last entry of the (rows, cols, 3) plane, alone, 5 off."""
    _MOVE[0] = 5.0
    try:
        yield
    finally:
        _MOVE[0] = 0.0


FAULTS = {"third_entry": third_entry}
'''


def test_a_cell_comparing_its_own_state_runs_without_edits(tmp_path):
    """A throwaway configuration whose accuracy compares a (rows, cols, 3)
    plane a neuron and, of the synapses, only the weights (no traces, no
    dopamine), with a traffic kind whose snapshot holds just those and a
    reference that computes just those and carries its own `FAULTS`, added
    as files: the cell runs through the harness as it is with ``correct``
    true, and the reference's planted fault, through `control`, reads
    ``correct`` false on every seed."""
    import control
    from snnbench import check
    cfg = json.load(open(os.path.join(BENCH, "configs", "izh_rstdp.json")))
    cfg.update(name="t_state_config", reference="t_state_ref",
               accuracy={"neurons": {"t$state": 2.0}, "firing": {"lft": 2},
                         "synapses": ["weights"], "synapse_rel": 1e-05},
               limits={"neurons_off": 0.01, "synapses_off": 0.01})
    cat = tiny_catalog(tmp_path)
    (tmp_path / "configs" / "t_state_config.json").write_text(
        json.dumps(cfg))
    (tmp_path / "traffic" / "t_state_mix.json").write_text(json.dumps(
        {"kind": "t_state", "rows": 16, "cols": 16, "steps": 320,
         "reward": 0.5, "v0": [-65.0, 30.0], "warmup_requests": 1,
         "check_requests": 2, "trace_requests": 1}))
    (tmp_path / "traffic" / "kinds" / "t_state.py").write_text(T_STATE_KIND)
    ref = open(os.path.join(BENCH, "reference", "izhikevich_lattice.py"))
    (tmp_path / "reference" / "t_state_ref.py").write_text(
        ref.read() + T_STATE_REF)
    cat.spec["workloads"].append({"name": "t_state_cell",
                                  "config": "t_state_config",
                                  "traffic": "t_state_mix", "chips": 1,
                                  "why": "t"})
    cell = cat.cell("t_state_cell")
    assert sorted(cell.reference.FAULTS) == ["third_entry"]
    got = run_cell(cat, "t_state_cell")
    assert got["correct"] and list(got["checks"]) == ["neurons_off",
                                                      "synapses_off"]
    for seed in (1, 2, 3):
        nums = control.control_numbers(cell, seed, 2, "cpu", "third_entry")
        ok, checks = check.verdict(nums, check.limits_of(cell))
        assert ok is False and nums["neurons_off"] == 1.0
        assert nums["synapses_off"] == 0.0

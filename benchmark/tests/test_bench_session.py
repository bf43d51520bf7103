"""One run of the harness on the CPU at small sizes: the result line's
keys, and ``correct`` coming out false when the timed path is broken
underneath (and for the control in the program's place)."""

import json

import pytest
import torch

from conftest import ROOT, TINY, run_cell, tiny_catalog

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def cat(tmp_path_factory):
    return tiny_catalog(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(TINY))
def test_last_line_keys(cat, cell):
    e2e = run_cell(cat, cell)
    assert list(e2e) == KEYS + ["checks"]
    assert e2e["correct"] and e2e["failed"] == 0 and e2e["attempted"] >= 1
    assert set(e2e["metrics"]) == {"neuron_updates_per_s",
                                   "request_ms_p95", "setup_s"}
    assert set(e2e["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for m in e2e["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in e2e["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(e2e)
    traced = run_cell(cat, cell, trace=True)
    assert list(traced) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "step_mfu" in traced["metrics"]
    assert not set(traced["metrics"]) & set(e2e["metrics"])


def _stencil_fault(mod, fault):
    twin = mod.izhikevich_stencil_steps_reference

    def broken(v, w, lft, weights, in_deg, params, offsets, clock0, n_steps,
               emit=False):
        if fault == "unchanged":
            return v, w, lft, torch.zeros_like(v, dtype=torch.bool), None
        out = list(twin(v, w, lft, weights, in_deg, params, offsets, clock0,
                        n_steps, emit))
        return _spoil(out, (v, w, lft), fault)
    return "izhikevich_stencil_steps_reference", broken


def _spoil(out, inputs, fault):
    """``out`` with half of the lattice's rows left at ``inputs``, or the
    voltage of every 16th neuron moved by 5 mV."""
    out = [x.clone() if isinstance(x, torch.Tensor) else x for x in out]
    if fault == "half":
        h = inputs[0].shape[0] // 2
        for o, i in zip(out, inputs):
            o[:h] = i[:h]
    else:
        out[0].view(-1)[::16] += 5.0
    return out


def _reward_fault(mod, fault):
    twin = mod.lattice_plasticity_steps_reference

    def broken(spec, v, w, lft, refr, weights, mask, in_deg, params, traces,
               dopamine, rule, rewards, clock0, n_steps):
        if fault == "unchanged":
            return (v, w, lft, refr, torch.zeros_like(v, dtype=torch.bool),
                    weights, traces, dopamine, None)
        out = list(twin(spec, v, w, lft, refr, weights, mask, in_deg, params,
                        traces, dopamine, rule, rewards, clock0, n_steps))
        if fault == "frozen_synapses":
            out[5], out[6] = weights, traces
            return out
        return _spoil(out, (v, w, lft), fault)
    return "lattice_plasticity_steps_reference", broken


def _loop_fault(mod, fault):
    twin = mod.env_step_launcher_reference

    def broken(spec, src, dst, spikes, *rest):
        launch = twin(spec, src, dst, spikes, *rest)
        clock = rest[-1]

        def step(reward=None):
            if fault == "frozen_synapses":
                kept = [t.clone() for t in (rest[0], *rest[4])]
                launch(reward)
                for t, k in zip((rest[0], *rest[4]), kept):
                    t.copy_(k)
                return
            if fault == "unchanged":
                for s, d in zip(src, dst):
                    if s is not None:
                        d.copy_(s)
                spikes.zero_()
                clock.add_(1)
                return
            launch(reward)
            got = _spoil([d for d in dst[:3]], src[:3], fault)
            for d, g in zip(dst, got):
                d.copy_(g)
        return step
    return "env_step_launcher_reference", broken


FAULTS = {"t_lattice": ("stencil_kernels", _stencil_fault),
          "t_reward": ("reward_kernels", _reward_fault),
          "t_loop": ("reward_kernels", _loop_fault)}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "frozen_synapses"])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_broken_timed_path_is_not_correct(cat, cell, fault, monkeypatch):
    """A step that returns its state unchanged, half of the lattice left
    out, an answer altered where it is produced (5 mV on every 16th
    neuron), and, with R-STDP, the weights, traces and visit counters left
    as they were while the neurons step: each comes out not correct."""
    if fault == "frozen_synapses" and cell == "t_lattice":
        pytest.skip("an electrical lattice has no plasticity to freeze")
    import importlib
    from snnbench import session
    session.import_port(ROOT)
    name, make = FAULTS[cell]
    mod = importlib.import_module(
        f"spiking_neural_networks_tpu_torch.ops.{name}")
    monkeypatch.setattr(mod, *make(mod, fault))
    got = run_cell(cat, cell)
    assert got["correct"] is False
    assert any(c["value"] > c["limit"] for c in got["checks"].values())


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_fails(cat, cell):
    """The reference in bfloat16 in the program's place comes out not
    correct through the run's own comparison."""
    import control
    from snnbench import check
    c = cat.cell(cell)
    limits = check.limits_of(c)
    for seed in (1, 2, 3):
        nums = control.control_numbers(c, seed, 2, "cpu")
        assert set(nums) == set(limits)
        ok, checks = check.verdict(nums, limits)
        assert ok is False
        assert any(x["value"] > x["limit"] for x in checks.values())


@pytest.mark.parametrize("cell", ["t_reward", "t_loop"])
def test_frozen_synapses_in_the_reference_fail(cat, cell):
    """`control`'s planted fault: R-STDP leaving the synapses as they were
    while the neurons step; ``synapses_off`` reads it."""
    import control
    from snnbench import check
    c = cat.cell(cell)
    for seed in (1, 2, 3):
        nums = control.control_numbers(c, seed, 2, "cpu",
                                       "frozen_synapses")
        ok, _ = check.verdict(nums, check.limits_of(c))
        assert ok is False
        assert nums["synapses_off"] > check.limits_of(c)["synapses_off"]

"""The comparison that decides ``correct`` (`snnbench.check`): the state it
compares is the one the configuration's ``accuracy`` names, on synthetic
dicts shaped as a Hodgkin-Huxley chemical lattice's state (gates a neuron,
neurotransmitter and receptor planes of three entries a neuron, plain
STDP's weights with no traces and no dopamine); and on the tiny cells the
numbers equal those of the comparison as it was when each configuration's
state was written into it."""

import importlib
import math
import os

import pytest
import torch

import test_bench_session as faults
from conftest import BENCH, ROOT, TINY, run_cell, tiny_catalog
from snnbench import catalog, check, session

ROWS, COLS, N_OFF = 8, 8, 12
N = ROWS * COLS
HH = {"neurons": {"v": 2.0, "na$m_state": 0.01, "na$h_state": 0.01,
                  "k$n_state": 0.01, "nt$t": 0.01, "rec$r": 0.01},
      "firing": {"lft": 2},
      "synapses": ["weights"], "synapse_rel": 1e-05}
LIMITS = {"neurons_off": 0.01, "synapses_off": 0.01}


def hh_state(seed=0):
    """A snapshot shaped as the HH chemical lattice's: (N,) planes, (N, 3)
    ``nt$t`` and ``rec$r``, the firing times (about half fired), and the
    stencil's (offsets, rows, cols) weights with their mask."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=g)
    state = {"v": -65.0 + 90.0 * u(N), "na$m_state": u(N),
             "na$h_state": u(N), "k$n_state": u(N), "nt$t": u(N, 3),
             "rec$r": u(N, 3),
             "lft": torch.where(u(N) < 0.5, -1,
                                (500 * u(N)).to(torch.int32)).to(torch.int32),
             "weights": 0.5 + u(N_OFF, ROWS, COLS)}
    mask = u(N_OFF, ROWS, COLS) < 0.8
    return state, mask


def copy(state):
    return {k: x.clone() for k, x in state.items()}


def test_equal_state_reads_zero_on_the_named_numbers_alone():
    ref, mask = hh_state()
    nums = check.numbers(copy(ref), ref, mask, HH)
    assert nums == {"neurons_off": 0.0, "synapses_off": 0.0}
    assert check.verdict(nums, LIMITS)[0] is True


@pytest.mark.parametrize("plane", sorted(HH["neurons"]))
def test_a_fault_in_each_neuron_plane_reads_over_its_limit(plane):
    """Every 8th neuron moved by twice its band (of a plane of three
    entries a neuron, its last entry alone): an eighth of the neurons off;
    half the band moves nothing."""
    ref, mask = hh_state()
    band = HH["neurons"][plane]
    for move, want in ((0.5 * band, 0.0), (2.0 * band, 1 / 8)):
        prog = copy(ref)
        x = prog[plane]
        if x.dim() == 2:
            x[::8, 2] += move
        else:
            x[::8] += move
        nums = check.numbers(prog, ref, mask, HH)
        assert nums["neurons_off"] == pytest.approx(want)
        assert nums["synapses_off"] == 0.0
        ok, checks = check.verdict(nums, LIMITS)
        assert ok is (want == 0.0)
    prog = copy(ref)
    prog[plane].view(-1)[5] = math.nan
    assert check.numbers(prog, ref, mask, HH)["neurons_off"] == 1 / N


def test_a_fault_in_the_firing_times_reads_over_its_limit():
    ref, mask = hh_state()
    fired = torch.nonzero(ref["lft"] >= 0).flatten()
    never = torch.nonzero(ref["lft"] < 0).flatten()
    prog = copy(ref)
    prog["lft"][fired[:4]] += 2                     # within the band
    assert check.numbers(prog, ref, mask, HH)["neurons_off"] == 0.0
    prog["lft"][fired[:4]] += 1                     # 3 steps off
    prog["lft"][never[:2]] = 7                      # fired on one side only
    assert check.numbers(prog, ref, mask, HH)["neurons_off"] == 6 / N


def test_a_fault_in_the_weights_reads_over_its_limit():
    ref, mask = hh_state()
    prog = copy(ref)
    edges = torch.nonzero(mask.flatten()).flatten()
    prog["weights"].view(-1)[edges[::10]] *= 1.001
    nums = check.numbers(prog, ref, mask, HH)
    assert nums["neurons_off"] == 0.0
    assert nums["synapses_off"] == pytest.approx(
        len(edges[::10]) / len(edges))
    assert check.verdict(nums, LIMITS)[0] is False
    # an edge outside the mask is not compared
    prog = copy(ref)
    prog["weights"][~mask] += 1.0
    assert check.numbers(prog, ref, mask, HH)["synapses_off"] == 0.0


def test_integer_synapse_planes_compare_exactly():
    ref, mask = hh_state()
    ref["counter"] = mask.to(torch.int32)
    prog = copy(ref)
    first = torch.nonzero(mask.flatten())[0]
    prog["counter"].view(-1)[first] += 1
    acc = dict(HH, synapses=["weights", "counter"])
    assert check.numbers(prog, ref, mask, acc)["synapses_off"] == \
        1 / int(mask.sum())


def test_scalars_read_their_relative_gap():
    ref, mask = hh_state()
    ref["dopamine"] = torch.tensor(2.0)
    prog = dict(copy(ref), dopamine=torch.tensor(2.5))
    nums = check.numbers(prog, ref, mask, dict(HH, scalars=["dopamine"]))
    assert list(nums) == ["neurons_off", "synapses_off", "dopamine_gap"]
    assert nums["dopamine_gap"] == 0.25


@pytest.mark.parametrize("side", ["prog", "ref"])
@pytest.mark.parametrize("key", sorted(HH["neurons"]) + ["lft", "weights"])
def test_a_named_key_missing_from_either_side_raises(key, side):
    ref, mask = hh_state()
    prog = copy(ref)
    del (prog if side == "prog" else ref)[key]
    with pytest.raises(KeyError, match="lacks"):
        check.numbers(prog, ref, mask, HH)


def test_a_plane_of_another_shape_raises():
    ref, mask = hh_state()
    prog = copy(ref)
    prog["nt$t"] = prog["nt$t"].t().contiguous()
    with pytest.raises(ValueError, match="shape"):
        check.numbers(prog, ref, mask, HH)
    ref["nt$t"] = prog["nt$t"]                      # (3, N): no neuron's
    with pytest.raises(ValueError, match="neuron"):
        check.numbers(prog, ref, mask, HH)


def test_a_limit_without_its_number_raises():
    with pytest.raises(KeyError, match="synapses_off"):
        check.verdict({"neurons_off": 0.0}, LIMITS)
    with pytest.raises(KeyError, match="dopamine_gap"):
        check.verdict({"neurons_off": 0.0, "dopamine_gap": 0.0},
                      {"neurons_off": 0.01})


def _quoted(keys, path):
    text = open(path).read()
    return sorted(k for k in keys if f'"{k}"' in text or f"'{k}'" in text)


def test_the_comparison_names_no_state_key():
    """`check.py` and `session.py` name no key of the state that either
    configuration compares, nor of the HH chemical lattice's state."""
    keys = {"last_firing_time", "dopamine", "c", "dw", "counter"}
    cat = catalog.Catalog()
    for c in cat.spec["configs"]:
        acc = cat.config(c["name"])["accuracy"]
        for group in ("neurons", "firing", "synapses", "scalars"):
            keys |= set(acc.get(group, ()))
    session.import_port(ROOT)
    hh = importlib.import_module(
        "spiking_neural_networks_tpu_torch.ops.hh_kernels")
    keys |= set(hh.STATE_KEYS) | set(HH["neurons"]) | set(HH["firing"])
    assert {"v", "w", "lft", "weights", "nt$t", "na$m_state"} <= keys
    for f in ("check.py", "session.py"):
        assert _quoted(keys, os.path.join(BENCH, "snnbench", f)) == [], f


# The comparison as it was before the configurations named their compared
# state (its limits unchanged), kept as the oracle of the one that reads it
# from them.

OLD_ACCURACY = {"band_mv": 2.0, "band_steps": 2, "synapse_rel": 1e-05}


def old_neurons_off(prog, ref, band_mv, band_steps):
    far = torch.zeros_like(prog["v"], dtype=torch.bool)
    for k in ("v", "w"):
        p = prog[k].float()
        far |= ((p - ref[k].float()).abs() > band_mv) | ~torch.isfinite(p)
    lp, lr = prog["lft"].long(), ref["lft"].long()
    one_side = (lp < 0) != (lr < 0)
    bad = far | one_side | ((lp - lr).abs() > band_steps)
    return float(bad.float().mean())


def old_far(p, r, rel):
    p, r = p.float(), r.float()
    scale = rel * torch.clamp(r.abs(), min=float(r.abs().max()) * rel)
    return ((p - r).abs() > scale) | ~torch.isfinite(p)


def old_synapses_off(prog, ref, mask, rel):
    bad = (old_far(prog["weights"], ref["weights"], rel)
           | old_far(prog["c"], ref["c"], rel)
           | old_far(prog["dw"], ref["dw"], rel)
           | (prog["counter"] != ref["counter"]))
    return float((bad & mask).sum()) / max(int(mask.sum()), 1)


def old_numbers(prog, ref, mask, cfg):
    acc = cfg["accuracy"]
    out = {"neurons_off": old_neurons_off(prog, ref, acc["band_mv"],
                                          acc["band_steps"])}
    if "weights" in ref:
        out["synapses_off"] = old_synapses_off(prog, ref, mask,
                                               acc["synapse_rel"])
        p, r = float(prog["dopamine"]), float(ref["dopamine"])
        out["dopamine_gap"] = abs(p - r) / max(abs(r), 1e-30) \
            if math.isfinite(p) else math.inf
    if "rewards" in ref:
        gap = (prog["rewards"].float().to(ref["rewards"].device)
               - ref["rewards"].float()).abs()
        out["rewards_gap"] = float(gap.max()) if bool(
            torch.isfinite(gap).all()) else math.inf
        out["rate_gap"] = abs(float(prog["rate"]) - float(ref["rate"]))
    return out


def _same(a, b):
    return list(a) == list(b) and all(
        x == y or (math.isnan(x) and math.isnan(y))
        for x, y in zip(a.values(), b.values()))


@pytest.fixture(scope="module")
def cat(tmp_path_factory):
    return tiny_catalog(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered",
                                   "frozen_synapses", "control",
                                   "reference_frozen_synapses"])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_numbers_equal_the_old_comparisons(cat, cell, fault,
                                               monkeypatch):
    """Over three seeds, every request that a run checks (sound, or with
    each fault of `test_bench_session` in the timed path) and every one
    that the control compares (bfloat16, or the reference's planted
    fault): the same numbers, in the same order, as the old comparison."""
    if fault and "frozen_synapses" in fault and cell == "t_lattice":
        pytest.skip("an electrical lattice has no plasticity to freeze")
    import control
    rows, new = [], check.compare

    def both(c, prog, ref, mask):
        got = new(c, prog, ref, mask)
        rows.append((old_numbers(prog, ref, mask,
                                 {"accuracy": OLD_ACCURACY}), got))
        return got
    monkeypatch.setattr(check, "compare", both)
    c = cat.cell(cell)
    if fault in ("control", "reference_frozen_synapses"):
        planted = fault.replace("reference_", "") if fault != "control" \
            else None
        for seed in (1, 2, 3):
            control.control_numbers(c, seed, 2, "cpu", planted)
    else:
        if fault is not None:
            session.import_port(ROOT)
            name, make = faults.FAULTS[cell]
            mod = importlib.import_module(
                f"spiking_neural_networks_tpu_torch.ops.{name}")
            monkeypatch.setattr(mod, *make(mod, fault))
        for seed in (11, 12, 13):
            got = run_cell(cat, cell, seed=seed, seconds=0.05)
            assert got["correct"] or fault is not None
    assert len(rows) >= 3
    for old, got in rows:
        assert _same(old, got), (old, got)

"""Liquid manifold generation: on/off input phases → voltage trajectories
→ low-dimensional neural manifold, on the port's core and `lixirnet`.

PyTorch counterpart of ``experiments/liquid_manifold_generation.py``, the
port of the reference's
`interface/experiments/liquid_custom_manifold_generation.py`
(and `liquid_manifold_generation.py`): drive defined regions of a recurrent
liquid with an input for an *on phase*, silence it for an *off phase*,
record the full voltage grid over time, report per-phase signal-to-noise of
the mean voltage, and export the flattened trajectories.  Where the
reference leaves the manifold determination to an offline plotting script,
here we also compute the PCA embedding directly (SVD of the centered
trajectory matrix) and report explained variance of the leading components.
The lattices run on the card (``device="cuda"``, ``--device cuda``, the
default) unless the caller names another device; the NumPy generator
draws stay in the JAX script's order, so one seed builds the same network.
The train's ``seed`` stands where the JAX script sets the train's key: a
network draws from its own generator, so in both packages it does not
reach the network's draws.

Run: python -m spiking_neural_networks_tpu_torch.experiments.\
liquid_manifold_generation [args.toml] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .pipeline_setup import output_path, signal_to_noise

import spiking_neural_networks_tpu_torch as snn
from ..ops.graph import DenseGraph


def build_liquid(rows=10, cols=10, seed=42, input_region=None,
                 device="cuda"):
    """Fixed recurrent liquid + a Poisson input lattice wired one-to-one into
    `input_region` (boolean grid mask; default: left half)."""
    rng = np.random.default_rng(seed)
    n = rows * cols
    liquid = snn.Lattice(snn.Izhikevich(), id=0, device=device)
    liquid.populate(rows, cols, gap_conductance=10.0)
    mask = rng.random((n, n)) < 0.1
    np.fill_diagonal(mask, False)
    w = rng.uniform(0.5, 1.5, (n, n)) * np.where(
        rng.random((n, n)) < 0.2, -1.0, 1.0)
    liquid.graph = DenseGraph(
        torch.as_tensor(np.where(mask, w, 0.0), dtype=torch.float32,
                        device=liquid.device),
        torch.as_tensor(mask, device=liquid.device))
    liquid.apply(lambda s: {**s, "v": torch.as_tensor(
        rng.uniform(-65, 20, n), dtype=torch.float32, device=liquid.device)})
    liquid.update_grid_history = True

    if input_region is None:
        input_region = np.zeros((rows, cols), bool)
        input_region[:, : cols // 2] = True

    inp = snn.SpikeTrainLattice(snn.PoissonSpikeTrain(), id=1, device=device)
    inp.populate(rows, cols)
    net = snn.LatticeNetwork.generate_network([liquid], [inp])
    net.connect(1, 0, lambda x, y: x == y, lambda x, y: 6.0)
    return net, liquid, inp, input_region


def set_firing(inp, region, rate_hz, dt=0.1):
    chance = snn.PoissonSpikeTrain.rate_to_chance(rate_hz, dt) if rate_hz \
        else 0.0
    inp.state = dict(inp.state)
    inp.state["chance_of_firing"] = torch.as_tensor(
        np.where(region.reshape(-1), chance, 0.0), dtype=torch.float32,
        device=inp.device)


def main(on_phase=300, off_phase=500, rate_hz=80.0, n_components=3,
         filename="liquid_manifold_output.json", device="cuda"):
    net, liquid, inp, region = build_liquid(device=device)
    inp.seed = 0

    # on phase: drive the region; off phase: silence and let the liquid relax
    set_firing(inp, region, rate_hz)
    net.run_lattices(on_phase)
    set_firing(inp, region, 0.0)
    net.run_lattices(off_phase)

    hist = np.stack(liquid.grid_history.history)          # (T, rows, cols)
    T = hist.shape[0]
    traj = hist.reshape(T, -1)                            # (T, N)
    voltages = traj.mean(axis=1)

    snr = {
        "first_half_on": float(signal_to_noise(voltages[: on_phase // 2])),
        "second_half_on": float(signal_to_noise(
            voltages[on_phase // 2: on_phase])),
        "off": float(signal_to_noise(voltages[on_phase:])),
    }

    # PCA of the centered trajectory: the liquid's neural manifold
    centered = traj - traj.mean(axis=0, keepdims=True)
    _, s, vt = np.linalg.svd(centered, full_matrices=False)
    var = s ** 2 / (s ** 2).sum()
    embedding = centered @ vt[:n_components].T            # (T, k)

    print(f"on-phase mean v {voltages[:on_phase].mean():.2f}, "
          f"off-phase mean v {voltages[on_phase:].mean():.2f}")
    print("signal-to-noise:", {k: round(v, 3) for k, v in snr.items()})
    print(f"explained variance (top {n_components}): "
          f"{[round(float(x), 3) for x in var[:n_components]]} "
          f"(total {var[:n_components].sum():.3f})")

    with open(output_path(filename), "w") as f:
        json.dump({
            "voltages": voltages.tolist(),
            "signal_to_noise": snr,
            "explained_variance": var[:n_components].tolist(),
            "embedding": embedding.tolist(),
        }, f)
    return snr, var[:n_components]


# ---------------------------------------------------------------------------
# Full TOML grid runner — port of the reference's CUSTOM-manifold protocol
# (the reference's
# `interface/experiments/liquid_custom_manifold_generation.py`),
# driven by `liquid_custom_manifold_args/*.toml` (per-position `input_table`
# chance-of-firing grids swept over trials).
# ---------------------------------------------------------------------------

_SIM_DEFAULTS = dict(
    exc_only=True, on_phase=1000, off_phase=5000, settling_period=1000,
    tolerance=2, peaks_on=False, trials=10, skew=1, exc_n=7, inh_n=3,
    dt=1, c_m=100, connectivity=0.25, inh_connectivity=0.25,
    internal_scalar=0.0125, inh_internal_scalar=2,
    # the reference reads measure_snr without defaulting it (its configs
    # always set it); default False so partial configs replay too
    measure_snr=False)

_VAR_DEFAULTS = dict(
    exc_to_inh_connectivity=[0.15], inh_to_exc_connectivity=[0.15],
    spike_train_connectivity=[1.0], spike_train_to_exc=[3],
    exc_to_inh_weight=[0.0125], inh_to_exc_weight=[0.0125],
    nmda_g=[0.6], ampa_g=[1], gabaa_g=[1.2],
    glutamate_clearance=[0.001], gabaa_clearance=[0.001])

_KEY_FIELDS = ["input_table", "spike_train_connectivity"]


def fill_defaults(parsed):
    """Reference `fill_defaults`
    (liquid_custom_manifold_generation.py:17-99)."""
    if "simulation_parameters" not in parsed:
        raise ValueError("Requires `simulation_parameters` table")
    if "filename" not in parsed["simulation_parameters"]:
        raise ValueError(
            "Requires `filename` field in `simulation_parameters`")
    if "variables" not in parsed:
        raise ValueError("Requires `variables` table")
    for k, v in _SIM_DEFAULTS.items():
        parsed["simulation_parameters"].setdefault(k, v)
    exc_n = parsed["simulation_parameters"]["exc_n"]
    parsed["variables"].setdefault(
        "input_table", [[[0 for _ in range(exc_n)] for _ in range(exc_n)]])
    for k, v in _VAR_DEFAULTS.items():
        parsed["variables"].setdefault(k, list(v))
    return parsed


def _run_custom_point(sp, cs, rng, device="cuda"):
    """One (combination, trial) of the custom-manifold protocol
    (liquid_custom_manifold_generation.py:167-326)."""
    from .pipeline_setup import (generate_setup_neuron,
                                 find_peaks_above_threshold)
    from .lsm_setup import (build_dopa_liquid_network,
                            generate_liquid_weights, stop_firing,
                            determine_return_to_baseline)

    exc_n, inh_n = sp["exc_n"], sp["inh_n"]
    w = generate_liquid_weights(exc_n * exc_n,
                                connectivity=sp["connectivity"],
                                scalar=sp["internal_scalar"], rng=rng)
    w_inh = None
    if not sp["exc_only"]:
        w_inh = generate_liquid_weights(
            inh_n * inh_n, connectivity=sp["inh_connectivity"],
            scalar=sp["inh_internal_scalar"], rng=rng)
    setup_neuron = generate_setup_neuron(sp["c_m"], sp["skew"], rng=rng)
    network, e1, i1, c1 = build_dopa_liquid_network(
        sp, cs, w, rng, w_inh=w_inh, setup_neuron=setup_neuron,
        device=device)
    network.connect(
        c1, e1,
        lambda x, y: rng.uniform(0, 1) < cs["spike_train_connectivity"],
        lambda x, y: cs["spike_train_to_exc"])

    table = cs["input_table"]

    def start_firing(pos, neuron):
        neuron.chance_of_firing = table[pos[0]][pos[1]]
        return neuron

    network.apply_spike_train_lattice(c1, stop_firing)
    network.run_lattices(sp["off_phase"])
    network.apply_spike_train_lattice_given_position(c1, start_firing)
    network.run_lattices(sp["on_phase"])
    network.apply_spike_train_lattice(c1, stop_firing)
    network.run_lattices(sp["off_phase"])

    hist = network.get_lattice(e1).history
    voltages = [float(np.array(i).mean()) for i in hist]
    out = {"return_to_baseline": determine_return_to_baseline(
        voltages, sp["settling_period"], sp["on_phase"], sp["off_phase"],
        sp["tolerance"]), "voltages": voltages}
    if sp["measure_snr"]:
        out["first_snr"] = float(signal_to_noise(
            voltages[sp["settling_period"]:sp["off_phase"]]))
        out["second_snr"] = float(signal_to_noise(
            voltages[sp["on_phase"] + sp["off_phase"]:]))
        out["during_disturbance"] = float(signal_to_noise(
            voltages[sp["on_phase"]:sp["on_phase"] + sp["off_phase"]]))
    if sp["peaks_on"]:
        data = np.array(hist).reshape(len(hist), -1)
        out["peaks"] = [
            [int(p) for p in find_peaks_above_threshold(data[:, i], 20)]
            for i in range(data.shape[1])]
    return out


def run_grid(argv, seed=0, device="cuda"):
    """TOML-grid entry point (custom-manifold reference protocol)."""
    import itertools
    from .pipeline_setup import parse_toml, generate_key_helper

    with open(argv[1], "rb") as f:
        parsed = parse_toml(f)
    fill_defaults(parsed)
    sp = parsed["simulation_parameters"]
    names = list(parsed["variables"].keys())
    combos = list(itertools.product(*parsed["variables"].values()))
    rng = np.random.default_rng(seed)
    out = {}
    for combo in combos:
        cs = dict(zip(names, combo))
        for trial in range(sp["trials"]):
            value = _run_custom_point(sp, cs, rng, device)
            cs["trial"] = trial
            key = [f"trial: {trial}"]
            for field in _KEY_FIELDS:
                generate_key_helper(cs, key, parsed, field)
            out[", ".join(key)] = value
    with open(output_path(sp["filename"]), "w") as f:
        json.dump(out, f, indent=1)
    return out


def cli(argv=None):
    """The command line: `run_grid` on a TOML, else `main` at its
    defaults, on ``--device``."""
    p = argparse.ArgumentParser()
    p.add_argument("toml", nargs="?", help="a custom-manifold TOML")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    if a.toml is not None:
        return run_grid([None, a.toml], device=a.device)
    return main(device=a.device)


if __name__ == "__main__":
    cli()

"""Isolated liquid disturbance-decay pipeline (TOML grid search), on the
port's `lixirnet`.

PyTorch counterpart of ``experiments/isolated_liquid_pipeline.py``, the
full port of the reference's
`interface/experiments/isolated_liquid_pipeline.py` (319 LoC): a
recurrent excitatory liquid (optionally plus an inhibitory group) with
chemical glutamate/GABA synapses receives a Poisson cue in an off/on/off
protocol; for every TOML variable combination x trial, the run
records how long the mean voltage takes to return to its pre-disturbance
baseline, optional SNR measurements per phase, and optional per-neuron
voltage peaks.

Usage:
    python -m spiking_neural_networks_tpu_torch.experiments.\
isolated_liquid_pipeline [args.toml] [--device cpu]

Without an argument a built-in smoke configuration runs.  Reference arg
files are replayed from `experiments/isolated_liquid_args/`.  The lattices
run on the card (``--device cuda``, the default) unless the caller names
another device; the NumPy generator draws stay in the JAX script's order,
so one seed builds the same network.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

import numpy as np

from .pipeline_setup import (output_path, parse_toml, generate_key_helper,
                            generate_setup_neuron, signal_to_noise,
                            find_peaks_above_threshold)
from .lsm_setup import (generate_liquid_weights, generate_start_firing,
                       stop_firing, determine_return_to_baseline)

from .. import lixirnet as ln

SIM_DEFAULTS = dict(
    exc_only=True, on_phase=1000, off_phase=5000, settling_period=1000,
    tolerance=2, peaks_on=False, measure_snr=False, trials=10, skew=1,
    exc_n=7, inh_n=3, dt=1, c_m=100, seed=0,
)

VAR_DEFAULTS = dict(
    cue_firing_rate=[0.01],
    connectivity=[0.25], inh_connectivity=[0.25],
    exc_to_inh_connectivity=[0.15], inh_to_exc_connectivity=[0.15],
    spike_train_connectivity=[0.5],
    internal_scalar=[0.125], spike_train_to_exc=[3],
    exc_to_inh_weight=[0.0125], inh_to_exc_weight=[0.0125],
    inh_internal_scalar=[2],
    nmda_g=[0.6], ampa_g=[1], gabaa_g=[1.2],
    glutamate_clearance=[0.001], gabaa_clearance=[0.001],
)

KEY_FIELDS = [
    "cue_firing_rate",
    "connectivity", "spike_train_connectivity", "inh_connectivity",
    "exc_to_inh_connectivity", "inh_to_exc_connectivity",
    "spike_train_to_exc", "internal_scalar", "inh_internal_scalar",
    "exc_to_inh_weight", "inh_to_exc_weight",
    "nmda_g", "ampa_g", "gabaa_g",
    "glutamate_clearance", "gabaa_clearance",
]


def fill_defaults(parsed):
    """isolated_liquid_pipeline.py:23-99 (with `measure_snr` defaulted —
    the reference crashes when it is absent from the TOML)."""
    if "simulation_parameters" not in parsed:
        raise ValueError("Requires `simulation_parameters` table")
    if "filename" not in parsed["simulation_parameters"]:
        raise ValueError("Requires `filename` field in `simulation_parameters`")
    if "variables" not in parsed:
        raise ValueError("Requires `variables` table")
    for k, v in SIM_DEFAULTS.items():
        parsed["simulation_parameters"].setdefault(k, v)
    for k, v in VAR_DEFAULTS.items():
        parsed["variables"].setdefault(k, list(v))


def generate_key(parsed, current_state):
    """isolated_liquid_pipeline.py:101-117."""
    key = [f"trial: {current_state['trial']}"]
    for field in KEY_FIELDS:
        generate_key_helper(current_state, key, parsed, field)
    return ", ".join(key)


def build_network(sp, cs, rng, device="cuda"):
    exc_n, inh_n = sp["exc_n"], sp["inh_n"]
    num, inh_num = exc_n * exc_n, inh_n * inh_n

    w = generate_liquid_weights(num, connectivity=cs["connectivity"],
                                scalar=cs["internal_scalar"], rng=rng)

    glu_neuro = ln.BoundedNeurotransmitterKinetics(
        clearance_constant=cs["glutamate_clearance"])
    gaba_neuro = ln.BoundedNeurotransmitterKinetics(
        clearance_constant=cs["gabaa_clearance"])
    exc_nts = {ln.DopaGluGABANeurotransmitterType.Glutamate: glu_neuro}
    inh_nts = {ln.DopaGluGABANeurotransmitterType.GABA: gaba_neuro}

    # NOTE: replicated reference quirk (isolated_liquid_pipeline.py:168-169):
    # the AMPA conductance is assigned from the `nmda_g` variable and the
    # NMDA conductance from `ampa_g`.
    glu = ln.GlutamateReceptor(g_ampa=cs["nmda_g"], g_nmda=cs["ampa_g"])
    gaba = ln.GABAReceptor(g=cs["gabaa_g"])
    receptors = ln.DopaGluGABA()
    receptors.insert(ln.DopaGluGABANeurotransmitterType.Glutamate, glu)
    receptors.insert(ln.DopaGluGABANeurotransmitterType.GABA, gaba)

    exc_neuron = ln.IzhikevichNeuron()
    exc_neuron.set_synaptic_neurotransmitters(exc_nts)
    exc_neuron.set_receptors(receptors)
    inh_neuron = ln.IzhikevichNeuron()
    inh_neuron.set_synaptic_neurotransmitters(inh_nts)
    inh_neuron.set_receptors(receptors)
    poisson = ln.PoissonNeuron()
    poisson.set_synaptic_neurotransmitters(exc_nts)

    setup_neuron = generate_setup_neuron(sp["c_m"], sp["skew"], rng=rng)

    exc_lattice = ln.IzhikevichNeuronLattice(0, device=device)
    exc_lattice.populate(exc_neuron, exc_n, exc_n)
    exc_lattice.apply(setup_neuron)
    p2i = exc_lattice.position_to_index
    exc_lattice.connect(lambda x, y: bool(w[p2i[x]][p2i[y]] != 0),
                        lambda x, y: float(w[p2i[x]][p2i[y]]))
    exc_lattice.update_grid_history = True

    spike_train_lattice = ln.PoissonLattice(1, device=device)
    spike_train_lattice.populate(poisson, exc_n, exc_n)

    lattices = [exc_lattice]
    if not sp["exc_only"]:
        w_inh = generate_liquid_weights(
            inh_num, connectivity=cs["inh_connectivity"],
            scalar=cs["inh_internal_scalar"], rng=rng)
        inh_lattice = ln.IzhikevichNeuronLattice(2, device=device)
        inh_lattice.populate(inh_neuron, inh_n, inh_n)
        inh_lattice.apply(setup_neuron)
        p2i_inh = inh_lattice.position_to_index
        inh_lattice.connect(
            lambda x, y: bool(w_inh[p2i_inh[x]][p2i_inh[y]] != 0),
            lambda x, y: float(w_inh[p2i_inh[x]][p2i_inh[y]]))
        lattices.append(inh_lattice)

    network = ln.IzhikevichNeuronNetwork.generate_network(
        lattices, [spike_train_lattice])
    network.set_dt(sp["dt"])

    if not sp["exc_only"]:
        network.connect(
            2, 0, lambda x, y: rng.uniform() < cs["inh_to_exc_connectivity"],
            lambda x, y: cs["inh_to_exc_weight"])
        network.connect(
            0, 2, lambda x, y: rng.uniform() < cs["exc_to_inh_connectivity"],
            lambda x, y: cs["exc_to_inh_weight"])
    network.connect(
        1, 0, lambda x, y: rng.uniform() < cs["spike_train_connectivity"],
        lambda x, y: cs["spike_train_to_exc"])
    network.electrical_synapse = False
    network.chemical_synapse = True
    return network


def run_trial(sp, cs, rng, device="cuda"):
    network = build_network(sp, cs, rng, device)
    start_firing = generate_start_firing(cs["cue_firing_rate"])
    on_phase, off_phase = sp["on_phase"], sp["off_phase"]

    network.apply_spike_train_lattice(1, stop_firing)
    network.run_lattices(off_phase)
    network.apply_spike_train_lattice(1, start_firing)
    network.run_lattices(on_phase)
    network.apply_spike_train_lattice(1, stop_firing)
    network.run_lattices(off_phase)

    hist = network.get_lattice(0).history
    voltages = [float(np.array(i).mean()) for i in hist]
    out = {"return_to_baseline": determine_return_to_baseline(
        voltages, sp["settling_period"], on_phase, off_phase,
        sp["tolerance"]), "voltages": voltages}

    if sp["measure_snr"]:
        out["first_snr"] = float(signal_to_noise(
            voltages[sp["settling_period"]:off_phase]))
        out["second_snr"] = float(signal_to_noise(
            voltages[on_phase + off_phase:]))
        out["during_disturbance"] = float(signal_to_noise(
            voltages[on_phase:on_phase + off_phase]))

    if sp["peaks_on"]:
        data = np.stack(hist).reshape(len(hist), -1)
        out["peaks"] = [
            [int(p) for p in find_peaks_above_threshold(data[:, i], 20)]
            for i in range(data.shape[1])]
    return out


def main(argv):
    cli = argparse.ArgumentParser(
        prog=argv[0] if argv else None,
        description="Isolated liquid disturbance decay on the port's "
                    "lixirnet; without a TOML, a built-in smoke config.")
    cli.add_argument("toml", nargs="?", help="the pipeline's TOML")
    cli.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = cli.parse_args(list(argv)[1:])
    if args.toml is not None:
        with open(args.toml, "rb") as f:
            parsed = parse_toml(f)
    else:  # built-in smoke config
        parsed = {
            "simulation_parameters": dict(
                filename="isolated_liquid_output.json", exc_only=False,
                on_phase=200, off_phase=500, settling_period=100,
                trials=1, measure_snr=True, exc_n=5, inh_n=3),
            "variables": dict(glutamate_clearance=[0.001, 0.01]),
        }
    fill_defaults(parsed)
    sp = parsed["simulation_parameters"]

    np.seterr(divide="ignore", invalid="ignore")
    combos = list(itertools.product(*parsed["variables"].values()))
    all_states = [dict(zip(parsed["variables"].keys(), c)) for c in combos]
    print(json.dumps(parsed, indent=4))

    rng = np.random.default_rng(sp["seed"])
    simulation_output = {}
    for current_state in all_states:
        for trial in range(sp["trials"]):
            value = run_trial(sp, current_state, rng, args.device)
            current_state["trial"] = trial
            simulation_output[generate_key(parsed, current_state)] = value
            print(f"{generate_key(parsed, current_state)} -> "
                  f"return_to_baseline={value['return_to_baseline']}")

    with open(output_path(sp["filename"]), "w") as f:
        json.dump(simulation_output, f, indent=4)
    print("Finished simulation")
    return simulation_output


if __name__ == "__main__":
    main(sys.argv)

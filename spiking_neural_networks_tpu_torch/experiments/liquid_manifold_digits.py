"""Per-digit liquid manifold data generation (plain variant), on the
port's `lixirnet`.

PyTorch counterpart of ``experiments/liquid_manifold_digits.py``, the port
of the reference's PLAIN manifold pipeline
(`interface/experiments/liquid_manifold_generation.py`):
for each sampled scikit-learn 8x8 digit, a Dopa-Izhikevich liquid (built
fresh per digit) is silenced for an off phase, then a Poisson cue lattice
is wired in through the `cue_to_liquid` column-spacing mask and driven for
an on phase, then silenced again; the per-neuron peak trains, firing rates,
and mean-voltage trajectory are keyed by (digit, class) for offline
manifold embedding.

Reference quirks replicated faithfully:
* the cue connection is created INSIDE the per-digit loop AFTER the first
  off-phase run (liquid_manifold_generation.py:230-238);
* `generate_start_firing(cue_firing_rate)` drives every cue neuron at the
  SAME rate — the sampled digit's pixels never reach the cue in the
  reference either (the trailing `start_firing` re-apply after the last
  run is also kept);
* `cue_to_liquid[x][y]` masks cue columns where `x_col % spacing == 0`.

Set ``encode_digit=True`` (an extension, off by default) to scale each cue
neuron's rate by the digit's pixel intensity, which is what the protocol
was plainly built toward.

The digits and their stratified sample are the repository's copy and
scikit-learn's split (`digits.load_digits`, `digits.train_test_split`; no
scikit-learn).  The lattices run on the card (``--device cuda``, the
default) unless the caller names another device; the NumPy generator
draws stay in the JAX script's order, so one seed builds the same
networks.

Run: python -m spiking_neural_networks_tpu_torch.experiments.\
liquid_manifold_digits args.toml [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .pipeline_setup import (output_path, parse_toml,
                             generate_setup_neuron,
                             find_peaks_above_threshold)
from .lsm_setup import (build_dopa_liquid_network, generate_liquid_weights,
                        generate_start_firing, stop_firing)

_SIM_DEFAULTS = dict(
    exc_only=True, on_phase=1000, off_phase=5000, skew=1, exc_n=7, inh_n=3,
    dt=1, c_m=25)

_VAR_DEFAULTS = dict(
    percentage_sample=0.1, spacing_term=3, cue_firing_rate=0.01,
    connectivity=0.25, inh_connectivity=0.25,
    exc_to_inh_connectivity=0.15, inh_to_exc_connectivity=0.15,
    spike_train_connectivity=0.5, internal_scalar=0.5,
    spike_train_to_exc=3, exc_to_inh_weight=0.0125,
    inh_to_exc_weight=0.0125, inh_internal_scalar=2,
    nmda_g=0.6, ampa_g=1, gabaa_g=1.2,
    glutamate_clearance=0.001, gabaa_clearance=0.001)

DIGITS_SIZE = 8


def fill_defaults(parsed):
    """Reference `fill_defaults` (liquid_manifold_generation.py:18-89);
    note this variant's `[variables]` holds SCALARS, not grids."""
    if "simulation_parameters" not in parsed:
        raise ValueError("Requires `simulation_parameters` table")
    if "filename" not in parsed["simulation_parameters"]:
        raise ValueError(
            "Requires `filename` field in `simulation_parameters`")
    if "variables" not in parsed:
        raise ValueError("Requires `variables` table")
    for k, v in _SIM_DEFAULTS.items():
        parsed["simulation_parameters"].setdefault(k, v)
    for k, v in _VAR_DEFAULTS.items():
        parsed["variables"].setdefault(k, v)
    return parsed


def run_digit(sp, cs, digit, rng, encode_digit=False, device="cuda"):
    """One per-digit protocol run (liquid_manifold_generation.py:139-270)."""
    exc_n, inh_n = sp["exc_n"], sp["inh_n"]
    spacing = cs["spacing_term"]
    # cue column mask (liquid_manifold_generation.py:118-123); indexed by
    # the CUE position, so only the (exc_n, exc_n) top-left slice matters
    side = DIGITS_SIZE * spacing
    cue_to_liquid = np.array([[i % spacing == 0 for i in range(side)]
                              for _ in range(side)])

    w = generate_liquid_weights(exc_n * exc_n,
                                connectivity=cs["connectivity"],
                                scalar=cs["internal_scalar"], rng=rng)
    w_inh = None
    if not sp["exc_only"]:
        w_inh = generate_liquid_weights(
            inh_n * inh_n, connectivity=cs["inh_connectivity"],
            scalar=cs["inh_internal_scalar"], rng=rng)
    setup_neuron = generate_setup_neuron(sp["c_m"], sp["skew"], rng=rng)
    network, e1, i1, c1 = build_dopa_liquid_network(
        sp, cs, w, rng, w_inh=w_inh, setup_neuron=setup_neuron,
        device=device)

    if encode_digit:
        pixels = np.asarray(digit, float).reshape(DIGITS_SIZE, DIGITS_SIZE)
        pixels = pixels / max(float(pixels.max()), 1e-9)

        def start_firing(pos, neuron):
            r, c = pos[0] % DIGITS_SIZE, pos[1] % DIGITS_SIZE
            neuron.chance_of_firing = cs["cue_firing_rate"] * pixels[r, c]
            return neuron

        apply_cue = lambda: network.apply_spike_train_lattice_given_position(
            c1, start_firing)
    else:
        apply_cue = lambda: network.apply_spike_train_lattice(
            c1, generate_start_firing(cs["cue_firing_rate"]))

    network.run_lattices(sp["off_phase"])
    # the reference wires the cue AFTER the first off phase — faithful
    network.connect(c1, e1, lambda x, y: bool(cue_to_liquid[x[0]][x[1]]),
                    lambda x, y: cs["spike_train_to_exc"])
    apply_cue()
    network.run_lattices(sp["on_phase"])
    network.apply_spike_train_lattice(c1, stop_firing)
    network.run_lattices(sp["off_phase"])
    apply_cue()   # trailing re-apply, no run follows (reference tail)

    hist = network.get_lattice(e1).history
    data = np.array(hist).reshape(len(hist), -1)
    peaks = [[int(p) for p in find_peaks_above_threshold(data[:, i], 20)]
             for i in range(data.shape[1])]
    return {"firing_rates": [len(p) for p in peaks], "peaks": peaks,
            "voltages": [float(v) for v in data.mean(axis=1)]}


def main(argv, seed=0, encode_digit=False, max_digits=None):
    from .digits import load_digits, train_test_split

    cli = argparse.ArgumentParser(
        prog=argv[0] if argv else None,
        description="Per-digit liquid manifold data on the port's "
                    "lixirnet.")
    cli.add_argument("toml", help="the pipeline's TOML")
    cli.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = cli.parse_args(list(argv)[1:])
    with open(args.toml, "rb") as f:
        parsed = parse_toml(f)
    fill_defaults(parsed)
    sp = parsed["simulation_parameters"]
    cs = parsed["variables"]

    digits = load_digits()
    subset = int(cs["percentage_sample"] * len(digits.data))
    data, _, target, _ = train_test_split(
        digits.data, digits.target, train_size=subset,
        stratify=digits.target, random_state=seed)
    if max_digits is not None:
        data, target = data[:max_digits], target[:max_digits]

    rng = np.random.default_rng(seed)
    out = {}
    for current_digit, current_class in zip(data, target):
        value = run_digit(sp, cs, current_digit, rng,
                          encode_digit=encode_digit, device=args.device)
        out[f"{current_digit.tolist()}|{int(current_class)}"] = value
    with open(output_path(sp["filename"]), "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main(sys.argv)

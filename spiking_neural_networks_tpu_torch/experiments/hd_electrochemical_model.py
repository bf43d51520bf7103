"""Electrochemical head-direction model (plain, no dopamine), on the
port's `lixirnet`.

PyTorch counterpart of ``experiments/hd_electrochemical_model.py``, the
port of the reference's `interface_gpu/experiments/
hd_electrochemical_model.py` (208 LoC): the same 60-neuron HD ring +
left/right shift-layer architecture as the dopaminergic variant, driven
only by the turning cells (direction 0 = right, rate 0.01) — the
reference's dopaminergic script is this model plus a tonic dopamine
train, so the network builder is shared
(hd_electrochemical_model_dopaminergic.build_network) with the
dopamine->HD projections pinned at weight 0 for the whole run, which is
exactly the plain model's drive (a zero-weight projection contributes no
current or neurotransmitter input).

Output mirrors the reference's analysis: per-neuron voltage peaks above
threshold 20 (the raster), windowed firing-rate center-of-mass angles
(the polar path-over-time plot, saved as data), and the `{"peaks": ...}`
JSON the reference writes with `-f`.  The lattices run on the card
(``device="cuda"``, the default) unless the caller names another device.

Usage:
    python -m spiking_neural_networks_tpu_torch.experiments.\
hd_electrochemical_model [-i ITER] [-t TURNING] [-f OUT.json] \
[--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .pipeline_setup import output_path, find_peaks_above_threshold
from .hd_electrochemical_model_dopaminergic import (build_network,
                                                   center_of_mass_ring,
                                                   HD_RING)


def main(iterations=10_000, turning=10.0, out_file=None, seed=0,
         device="cuda"):
    rng = np.random.default_rng(seed)
    net = build_network(rng, turning, device=device)
    net.run_lattices(iterations)

    hist = np.stack(net.get_lattice(HD_RING).history)
    data = hist.reshape(hist.shape[0], -1)
    peaks = [find_peaks_above_threshold(data[:, i], 20)
             for i in range(data.shape[1])]

    # reference lines 185-196: spike counts per 100-step window -> ring
    # center of mass = the bump's angle over time
    window = 100
    thetas = []
    for i in range(0, iterations, window):
        counts = np.array([
            len([j for j in p if i - window < j <= i]) for p in peaks])
        thetas.append(float(center_of_mass_ring(counts)))

    out = {"peaks": [[int(p) for p in sub] for sub in peaks],
           "thetas": thetas,
           "parameters": dict(iterations=iterations, turning=turning,
                              seed=seed)}
    path = output_path(out_file or "hd_electrochemical_output.json")
    with open(path, "w") as f:
        json.dump(out, f)
    total = sum(len(p) for p in peaks)
    print(f"hd electrochemical: {total} peaks; "
          f"mean theta {np.nanmean(thetas):.1f}; saved {path}")
    return out


def cli(argv=None):
    """The command line: `main` with its options on ``--device``."""
    p = argparse.ArgumentParser(
        description="Electrochemical model of head direction")
    p.add_argument("-i", "--iterations", required=False)
    p.add_argument("-t", "--turning", required=False)
    p.add_argument("-f", "--file", required=False)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    return main(iterations=int(a.iterations) if a.iterations else 10_000,
                turning=float(a.turning) if a.turning else 10.0,
                out_file=a.file, device=a.device)


if __name__ == "__main__":
    cli()

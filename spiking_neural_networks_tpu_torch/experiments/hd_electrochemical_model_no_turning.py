"""Electrochemical head-direction ring pinned at a fixed angle (no
turning), on the port's `lixirnet`.

PyTorch counterpart of ``experiments/hd_electrochemical_model_no_turning.
py``, which implements the experiment sketched in the reference's
`interface_gpu/experiments/hd_electrochemical_model_no_turning.py` (a
2-line design note in the reference: "electrochemical model set to a
specific angle, no turning" + "increase inhibition of neurons that are
farther away"): a 60-neuron HD ring with chemical glutamate synapses and
an inhibitory partner ring whose projection strength GROWS with ring
distance (the distance-scaled inhibition the note asks for), cued to a
target angle by a rate spike train, then released.  The output measures
how well the bump holds the cued angle without any turning input.  The
lattices run on the card (``device="cuda"``, the default) unless the
caller names another device.

Usage:
    python -m spiking_neural_networks_tpu_torch.experiments.\
hd_electrochemical_model_no_turning [--angle N] [--iterations N] \
[--cue-iterations N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .pipeline_setup import output_path, find_peaks_above_threshold
from .hd_electrochemical_model_dopaminergic import (center_of_mass_ring,
                                                   ring_distance)

from .. import lixirnet as ln

N = 60
HD, HD_INH, CUE = 0, 1, 2


def hd_weight(x, y):
    return 3 * np.exp(-2 * ring_distance(N, x[0], y[0]) ** 2 / (N * 3)) - 0.9


def distance_scaled_inhibition(x, y):
    """Inhibition grows with ring distance (the note's 'increase inhibition
    of neurons that are farther away'): near-zero locally, saturating at
    full strength across the ring."""
    d = ring_distance(N, x[0], y[0])
    return 2.0 * (1.0 - np.exp(-d ** 2 / (N * 1.5)))


def main(angle=15, iterations=3000, cue_iterations=2000, seed=0,
         device="cuda"):
    rng = np.random.default_rng(seed)

    glu = ln.GlutamateReceptor()
    gabaa = ln.GABAReceptor()
    receptors = ln.DopaGluGABA()
    receptors.insert(ln.DopaGluGABANeurotransmitterType.Glutamate, glu)
    receptors.insert(ln.DopaGluGABANeurotransmitterType.GABA, gabaa)

    glu_nts = {ln.DopaGluGABANeurotransmitterType.Glutamate:
               ln.BoundedNeurotransmitterKinetics(clearance_constant=0.001)}
    gaba_nts = {ln.DopaGluGABANeurotransmitterType.GABA:
                ln.BoundedNeurotransmitterKinetics(clearance_constant=0.001)}

    exc_neuron = ln.IzhikevichNeuron()
    exc_neuron.set_synaptic_neurotransmitters(glu_nts)
    exc_neuron.set_receptors(receptors)
    inh_neuron = ln.IzhikevichNeuron()
    inh_neuron.set_synaptic_neurotransmitters(gaba_nts)
    inh_neuron.set_receptors(receptors)
    cue_train = ln.RateSpikeTrain()
    cue_train.set_synaptic_neurotransmitters(glu_nts)

    def setup_neuron(neuron):
        neuron.current_voltage = float(rng.uniform(neuron.c, neuron.v_th))
        neuron.c_m = 25
        return neuron

    hd = ln.IzhikevichNeuronLattice(HD, device=device)
    hd.populate(exc_neuron, N, 1)
    hd.connect(lambda x, y: True, hd_weight)
    hd.apply(setup_neuron)
    hd.update_grid_history = True

    hd_inh = ln.IzhikevichNeuronLattice(HD_INH, device=device)
    hd_inh.populate(inh_neuron, N, 1)
    hd_inh.connect(lambda x, y: True, hd_weight)
    hd_inh.apply(setup_neuron)

    cue = ln.RateSpikeTrainLattice(CUE, device=device)
    cue.populate(cue_train, N, 1)
    cue.apply_given_position(
        lambda pos, n: setattr(
            n, "rate",
            0.01 if ring_distance(N, pos[0], angle) <= 2 else 0.0) or n)

    net = ln.IzhikevichNeuronNetwork.generate_network([hd, hd_inh], [cue])
    # input averaging divides by total in-degree (~2N+1), so the one-to-one
    # cue weight must counteract the dilution (same as grid_cell_model.py)
    net.connect(CUE, HD, lambda x, y: x[0] == y[0],
                lambda x, y: float(2 * N + 1) * 4.0)
    net.connect(HD, HD_INH, lambda x, y: True,
                lambda x, y: max(hd_weight(x, y), 0))
    net.connect(HD_INH, HD, lambda x, y: True, distance_scaled_inhibition)
    net.set_dt(1)
    net.electrical_synapse = False
    net.chemical_synapse = True

    net.run_lattices(cue_iterations)
    # release the cue: the ring must hold the angle on its own
    net.apply_spike_train_lattice(CUE, lambda n: setattr(n, "rate", 0.0) or n)
    net.run_lattices(iterations)

    hist = np.stack(net.get_lattice(HD).history)
    data = hist.reshape(hist.shape[0], -1)
    peaks = [find_peaks_above_threshold(data[:, i], 20)
             for i in range(data.shape[1])]

    def window_theta(lo, hi):
        counts = np.array([len([j for j in p if lo <= j < hi])
                           for p in peaks])
        return float(center_of_mass_ring(counts)) if counts.sum() else None

    held = window_theta(cue_iterations, cue_iterations + iterations)
    cued = window_theta(cue_iterations // 2, cue_iterations)
    drift = (None if held is None or cued is None
             else abs((held - cued + N / 2) % N - N / 2))
    out = dict(angle=angle, cued_theta=cued, held_theta=held, drift=drift,
               peaks=[[int(p) for p in sub] for sub in peaks])
    path = output_path("hd_no_turning_output.json")
    with open(path, "w") as f:
        json.dump(out, f)
    print(f"hd no-turning: cued theta {cued}, held theta {held}, "
          f"drift {drift}; saved {path}")
    return out


def cli(argv=None):
    """The command line: `main` with its options on ``--device``."""
    p = argparse.ArgumentParser()
    p.add_argument("--angle", type=int, default=15)
    p.add_argument("--iterations", type=int, default=3000)
    p.add_argument("--cue-iterations", type=int, default=2000)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    return main(angle=a.angle, iterations=a.iterations,
                cue_iterations=a.cue_iterations, device=a.device)


if __name__ == "__main__":
    cli()

"""Dopaminergic electrochemical head-direction model, on the port's
`lixirnet`.

PyTorch counterpart of ``experiments/hd_electrochemical_model_dopaminergic.
py``, the port of the reference's `interface_gpu/experiments/
hd_electrochemical_model_dopaminergic.py`: a 60-neuron HD ring with
excitatory + inhibitory populations and left/right shift layers, all
coupled through chemical glutamate/GABA synapses, plus a tonic
dopaminergic rate spike train.  The first half of the run has the
dopamine->HD projections at weight 0; halfway through they switch to the
requested dopamine strength (D1-dominant receptors), biasing the ring's
excitability.  The output records per-neuron voltage peaks and the bump's
center-of-mass trajectory (the reference's polar plot, saved as data
instead of shown).  The lattices run on the card (``device="cuda"``, the
default) unless the caller names another device.

Usage:
    python -m spiking_neural_networks_tpu_torch.experiments.\
hd_electrochemical_model_dopaminergic [-i ITER] [-d DOPAMINE] \
[-t TURNING] [-f OUT.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .pipeline_setup import output_path, find_peaks_above_threshold

from .. import lixirnet as ln

N = 60

LEFT_RING, RIGHT_RING, HD_RING, TURNING = 0, 1, 2, 3
LEFT_RING_INH, RIGHT_RING_INH, HD_INH_RING, DOPAMINERGIC = 4, 5, 6, 7


def circular_displacement(length, theta1, theta2):
    raw = theta2 - theta1
    return (raw + length / 2) % length - (length / 2)


def ring_distance(length, i, j):
    return min(abs(i - j), length - abs(i - j))


def sigmoid_second_derivative(x):
    return -1 * ((np.exp(x) * (np.exp(x) - 1)) / (np.exp(x) + 1) ** 3)


def hd_weight(x, y):
    return 3 * np.exp(-2 * ring_distance(N, x[0], y[0]) ** 2 / (N * 3)) - 0.9


def hd_to_shift_weight(x, y):
    return 1 * (np.exp(-2 * ring_distance(N, x[0], y[0]) ** 2 / (N * 3)) - 0.2)


def shift_left_weight(x, y):
    return 20 * sigmoid_second_derivative(
        circular_displacement(N, x[0], y[0]) / 10)


def shift_right_weight(x, y):
    return -20 * sigmoid_second_derivative(
        circular_displacement(N, x[0], y[0]) / 10)


def center_of_mass_ring(arr):
    """hd_electrochemical_model_dopaminergic.py:201-216."""
    length = len(arr)
    angles = 2 * np.pi * np.arange(length) / length
    angle = np.arctan2((np.sin(angles) * arr).sum(),
                       (np.cos(angles) * arr).sum())
    if angle < 0:
        angle += 2 * np.pi
    return (angle * length) / (2 * np.pi)


def build_network(rng, turning_strength, turning_direction=0,
                  device="cuda"):
    glu = ln.GlutamateReceptor()
    gabaa = ln.GABAReceptor()
    dopa = ln.DopamineReceptor(s_d1=1.0)
    receptors = ln.DopaGluGABA()
    receptors.insert(ln.DopaGluGABANeurotransmitterType.Glutamate, glu)
    receptors.insert(ln.DopaGluGABANeurotransmitterType.GABA, gabaa)
    receptors.insert(ln.DopaGluGABANeurotransmitterType.Dopamine, dopa)

    glu_nts = {ln.DopaGluGABANeurotransmitterType.Glutamate:
               ln.BoundedNeurotransmitterKinetics(clearance_constant=0.001)}
    gaba_nts = {ln.DopaGluGABANeurotransmitterType.GABA:
                ln.BoundedNeurotransmitterKinetics(clearance_constant=0.001)}
    dopa_nts = {ln.DopaGluGABANeurotransmitterType.Dopamine:
                ln.BoundedNeurotransmitterKinetics(clearance_constant=0.002)}

    exc_neuron = ln.IzhikevichNeuron()
    exc_neuron.set_synaptic_neurotransmitters(glu_nts)
    exc_neuron.set_receptors(receptors)
    inh_neuron = ln.IzhikevichNeuron()
    inh_neuron.set_synaptic_neurotransmitters(gaba_nts)
    inh_neuron.set_receptors(receptors)

    rate_spike_train = ln.RateSpikeTrain()
    rate_spike_train.set_synaptic_neurotransmitters(glu_nts)
    dopamine_spike_train = ln.RateSpikeTrain()
    dopamine_spike_train.set_synaptic_neurotransmitters(dopa_nts)

    def setup_neuron(neuron):
        neuron.current_voltage = float(rng.uniform(neuron.c, neuron.v_th))
        neuron.c_m = 25
        return neuron

    def make_ring(lattice_id, neuron, connect=False, history=True):
        lat = ln.IzhikevichNeuronLattice(lattice_id, device=device)
        lat.populate(neuron, N, 1)
        if connect:
            lat.connect(lambda x, y: True, hd_weight)
        lat.apply(setup_neuron)
        lat.update_grid_history = history
        return lat

    shift_left = make_ring(LEFT_RING, exc_neuron)
    shift_right = make_ring(RIGHT_RING, exc_neuron)
    shift_left_inh = make_ring(LEFT_RING_INH, inh_neuron)
    shift_right_inh = make_ring(RIGHT_RING_INH, inh_neuron)
    hd = make_ring(HD_RING, exc_neuron, connect=True)
    hd_inh = make_ring(HD_INH_RING, inh_neuron, connect=True)

    turning_cells = ln.RateSpikeTrainLattice(TURNING, device=device)
    turning_cells.populate(rate_spike_train, 2, 1)
    turning_cells.apply_given_position(
        lambda pos, n: setattr(
            n, "rate", 0.01 if pos[0] == turning_direction else 0.0) or n)

    dopaminergic_cells = ln.RateSpikeTrainLattice(DOPAMINERGIC, device=device)
    dopaminergic_cells.populate(dopamine_spike_train, 1, 1)
    dopaminergic_cells.apply(lambda n: setattr(n, "rate", 0.01) or n)

    inh_strength = 2
    net = ln.IzhikevichNeuronNetwork.generate_network(
        [shift_left, shift_right, shift_left_inh, shift_right_inh, hd_inh,
         hd], [turning_cells, dopaminergic_cells])
    # dopamine projections start OFF; enabled at half time
    net.connect(DOPAMINERGIC, HD_RING, lambda x, y: True, lambda x, y: 0)
    net.connect(DOPAMINERGIC, HD_INH_RING, lambda x, y: True, lambda x, y: 0)
    net.connect(TURNING, LEFT_RING, lambda x, y: True,
                lambda x, y: turning_strength)
    net.connect(LEFT_RING, HD_RING, lambda x, y: True,
                lambda x, y: max(shift_right_weight(x, y), 0))
    net.connect(LEFT_RING, LEFT_RING_INH, lambda x, y: True,
                lambda x, y: max(-inh_strength * shift_right_weight(x, y), 0))
    net.connect(LEFT_RING_INH, HD_RING, lambda x, y: True,
                lambda x, y: max(-1 * shift_right_weight(x, y), 0))
    net.connect(RIGHT_RING, HD_RING, lambda x, y: True,
                lambda x, y: max(shift_left_weight(x, y), 0))
    net.connect(RIGHT_RING, RIGHT_RING_INH, lambda x, y: True,
                lambda x, y: max(-inh_strength * shift_left_weight(x, y), 0))
    net.connect(RIGHT_RING_INH, HD_RING, lambda x, y: True,
                lambda x, y: max(-1 * shift_left_weight(x, y), 0))
    net.connect(HD_RING, LEFT_RING, lambda x, y: True,
                lambda x, y: max(hd_to_shift_weight(x, y), 0))
    net.connect(HD_RING, HD_INH_RING, lambda x, y: True,
                lambda x, y: max(-inh_strength * hd_to_shift_weight(x, y), 0))
    net.connect(HD_INH_RING, LEFT_RING, lambda x, y: True,
                lambda x, y: max(-1 * hd_to_shift_weight(x, y), 0))
    net.connect(HD_RING, RIGHT_RING, lambda x, y: True,
                lambda x, y: max(hd_to_shift_weight(x, y), 0))
    net.connect(HD_INH_RING, RIGHT_RING, lambda x, y: True,
                lambda x, y: max(-1 * hd_to_shift_weight(x, y), 0))
    net.set_dt(1)
    net.electrical_synapse = False
    net.chemical_synapse = True
    return net


def main(iterations=10_000, dopamine=1.0, turning=10.0, out_file=None,
         seed=0, device="cuda"):
    rng = np.random.default_rng(seed)
    net = build_network(rng, turning, device=device)

    net.run_lattices(iterations)
    # enable tonic dopamine -> HD projections for the second half
    net.connect(DOPAMINERGIC, HD_RING, lambda x, y: True,
                lambda x, y: dopamine)
    net.connect(DOPAMINERGIC, HD_INH_RING, lambda x, y: True,
                lambda x, y: dopamine)
    net.run_lattices(iterations)

    hist = np.stack(net.get_lattice(HD_RING).history)
    data = hist.reshape(hist.shape[0], -1)
    peaks = [find_peaks_above_threshold(data[:, i], 20)
             for i in range(data.shape[1])]

    window = 100
    thetas = []
    for i in range(0, 2 * iterations, window):
        counts = np.array([
            len([j for j in p if i - window < j <= i]) for p in peaks])
        thetas.append(float(center_of_mass_ring(counts)))

    out = {"peaks": [[int(p) for p in sub] for sub in peaks],
           "thetas": thetas,
           "parameters": dict(iterations=iterations, dopamine=dopamine,
                              turning=turning, seed=seed)}
    path = output_path(out_file or "hd_dopaminergic_output.json")
    with open(path, "w") as f:
        json.dump(out, f)
    total = sum(len(p) for p in peaks)
    print(f"hd dopaminergic: {total} peaks; "
          f"mean theta first half {np.nanmean(thetas[:len(thetas)//2]):.1f} "
          f"second half {np.nanmean(thetas[len(thetas)//2:]):.1f}; "
          f"saved {path}")
    return out


def cli(argv=None):
    """The command line: `main` with its options on ``--device``."""
    p = argparse.ArgumentParser(
        description="Electrochemical model of head direction")
    p.add_argument("-i", "--iterations", required=False)
    p.add_argument("-d", "--dopamine", required=False)
    p.add_argument("-t", "--turning", required=False)
    p.add_argument("-f", "--file", required=False)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    return main(iterations=int(a.iterations) if a.iterations else 10_000,
                dopamine=float(a.dopamine) if a.dopamine else 1.0,
                turning=float(a.turning) if a.turning else 10.0,
                out_file=a.file, device=a.device)


if __name__ == "__main__":
    cli()

"""Liquid state machine: reservoir dynamics and the separation property,
on the port's core.

PyTorch counterpart of ``experiments/liquid_state_machine.py``, the port of
the reference's liquid pipelines
(`interface/experiments/isolated_liquid_pipeline.py`,
`liquid_custom_manifold_generation.py`): a recurrent Izhikevich "liquid"
driven by Poisson-encoded inputs; we measure the separation property —
liquid states for *different* input patterns should diverge more than states
for *noisy repeats of the same* pattern — which is what makes the reservoir a
useful temporal kernel for readouts.  The lattices run on the card
(``device="cuda"``, the default) unless the caller names another device;
the NumPy generator draws stay in the JAX script's order, so one seed
builds the same liquid.  The train's ``seed`` stands where the JAX script
sets the train's key: a network draws from its own generator, so in both
packages neither reaches the network's draws.

Run: python -m spiking_neural_networks_tpu_torch.experiments.\
liquid_state_machine [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import spiking_neural_networks_tpu_torch as snn
from ..ops.graph import DenseGraph


def liquid_state(net, liquid, iterations, tau=20.0):
    """Run and return the exponentially filtered spike-count state vector."""
    liquid.grid_history.reset()
    liquid.update_grid_history = True
    net.run_lattices(iterations)
    spikes = (np.stack(liquid.grid_history.history) >= 29.0)  # (T, r, c)
    t = np.arange(spikes.shape[0])[:, None, None]
    weights = np.exp(-(spikes.shape[0] - 1 - t) / tau)
    return (spikes * weights).sum(axis=0).reshape(-1)


def build(seed, pattern, rows=10, cols=10, rate_hz=80.0, liquid_seed=42,
          device="cuda"):
    # the liquid (weights + initial state) is FIXED across conditions; only
    # the input pattern and its Poisson realization vary
    rng = np.random.default_rng(liquid_seed)
    liquid = snn.Lattice(snn.Izhikevich(), id=0, device=device)
    liquid.populate(rows, cols, gap_conductance=10.0)
    # sparse random recurrent weights, 20% inhibitory (liquid topology)
    n = rows * cols
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

    inp = snn.SpikeTrainLattice(snn.PoissonSpikeTrain(), id=1, device=device)
    inp.populate(rows, cols)
    chance = snn.PoissonSpikeTrain.rate_to_chance(rate_hz, 0.1)
    inp.state = dict(inp.state)
    inp.state["chance_of_firing"] = torch.as_tensor(
        np.where(pattern.reshape(-1), chance, 0.0), dtype=torch.float32,
        device=inp.device)
    inp.seed = seed

    net = snn.LatticeNetwork.generate_network([liquid], [inp])
    net.connect(1, 0, lambda x, y: x == y, lambda x, y: 6.0)
    return net, liquid


def main(iterations=800, device="cuda"):
    rng = np.random.default_rng(0)
    pattern_a = rng.random((10, 10)) < 0.3
    pattern_b = rng.random((10, 10)) < 0.3

    def noisy(p, level=0.05, seed=1):
        r = np.random.default_rng(seed)
        return np.where(r.random(p.shape) < level, ~p, p)

    states = {}
    for name, (pattern, seed) in {
        "a1": (pattern_a, 1), "a2": (noisy(pattern_a), 2),
        "b1": (pattern_b, 3), "b2": (noisy(pattern_b), 4),
    }.items():
        net, liquid = build(seed, pattern, device=device)
        states[name] = liquid_state(net, liquid, iterations)

    def dist(x, y):
        return float(np.linalg.norm(states[x] - states[y]))

    within = (dist("a1", "a2") + dist("b1", "b2")) / 2
    between = (dist("a1", "b1") + dist("a1", "b2")
               + dist("a2", "b1") + dist("a2", "b2")) / 4
    print(f"within-class distance:  {within:.2f}")
    print(f"between-class distance: {between:.2f}")
    print(f"separation ratio: {between / max(within, 1e-9):.2f} "
          f"({'OK' if between > within else 'WEAK'})")
    return within, between


def cli(argv=None):
    """The command line: `main` at its defaults on ``--device``."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    return main(device=a.device)


if __name__ == "__main__":
    cli()

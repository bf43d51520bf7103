"""Hopfield attractor utilities and the discrete bipolar neuron lattice.

PyTorch counterpart of ``spiking_neural_networks_tpu/attractors.py`` (the
reference's ``backend/src/neuron/attractors/mod.rs``): the weight builders
and pattern generators are NumPy, `distort_pattern` draws from a seed or a
`torch.Generator`, and the discrete lattice is one +/-1 float32 state
vector on a device, updated by sequential sweeps.
"""

from __future__ import annotations

import numpy as np
import torch


def generate_hopfield_network(patterns):
    """Bipolar outer-product learning with zero diagonal
    (`generate_hopfield_network`, attractors/mod.rs:486-557).

    ``patterns``: (P, rows, cols) bool/0-1 array.  Returns (N, N) float32
    NumPy weights, N = rows * cols (w[i, j] = edge i -> j).
    """
    pats = np.asarray(patterns)
    if pats.ndim != 3:
        raise ValueError("patterns must be (P, rows, cols)")
    p = pats.shape[0]
    flat = np.where(pats.reshape(p, -1), 1.0, -1.0).astype(np.float32)
    w = flat.T @ flat
    np.fill_diagonal(w, 0.0)
    return w


def generate_binary_hopfield_network(patterns, a, b, scalar):
    """Binary-pattern variant (`generate_binary_hopfield_network`,
    attractors/mod.rs:577-654): dw[i, j] = (x_i - b)(x_j - a) * scalar,
    zero diagonal, float32 NumPy.

    The reference materializes every off-diagonal edge, zero-weight ones
    included (attractors/mod.rs:645-650), and zero-weight edges still
    count in the gap-junction input average (neuron/mod.rs:722-729): to
    reproduce its dynamics, wire a lattice with a full off-diagonal mask
    (``~np.eye(n, dtype=bool)``), not ``w != 0``."""
    pats = np.asarray(patterns)
    p = pats.shape[0]
    flat = np.where(pats.reshape(p, -1), 1.0, 0.0).astype(np.float32)
    w = ((flat - b).T @ (flat - a)) * scalar
    np.fill_diagonal(w, 0.0)
    return w


def distort_pattern(pattern, noise_level, generator=None, seed=None):
    """Flip each bit of ``pattern`` with probability ``noise_level``
    (`distort_pattern`, attractors/mod.rs:657-678).  The uniforms come
    from ``generator`` (a CPU `torch.Generator`) where given, else from
    NumPy's generator seeded by ``seed``; with neither, fresh noise each
    call, as the reference's thread RNG."""
    pattern = np.asarray(pattern, bool)
    if generator is not None:
        u = torch.rand(pattern.shape, generator=generator,
                       dtype=torch.float64).numpy()
    else:
        u = np.random.default_rng(seed).random(pattern.shape)
    flips = u <= noise_level
    return np.where(flips, ~pattern, pattern)


def generate_random_patterns(rows, cols, num_patterns, p_one, seed=0):
    """`generate_random_patterns` (attractors/mod.rs:682-703): i.i.d.
    Bernoulli(p_one) boolean patterns."""
    rng = np.random.default_rng(seed)
    return rng.random((num_patterns, rows, cols)) < p_one


class DiscreteNeuronLattice:
    """Bipolar discrete-neuron lattice (`DiscreteNeuronLattice`,
    attractors/mod.rs:359-462) on ``device``.

    The state is an (N,) +/-1 float32 vector, the weights (N, N) float32.
    `iterate` sweeps the neurons in row-major order, each taking the sign
    of its input from the states so far (`DiscreteNeuronLattice::iterate`,
    :443-461).
    """

    def __init__(self, rows, cols, weights=None, device="cuda"):
        self.rows, self.cols = rows, cols
        self.device = torch.device(device)
        n = rows * cols
        self.state = torch.full((n,), -1.0, dtype=torch.float32,
                                device=self.device)
        self.weights = (torch.zeros((n, n), dtype=torch.float32,
                                    device=self.device)
                        if weights is None else
                        torch.as_tensor(np.asarray(weights, np.float32),
                                        device=self.device))

    @classmethod
    def generate_lattice_from_dimension(cls, rows, cols, device="cuda"):
        return cls(rows, cols, device=device)

    def input_pattern_into_discrete_grid(self, pattern):
        """`input_pattern_into_discrete_grid` (attractors/mod.rs:398-408)."""
        pat = np.asarray(pattern, bool).reshape(-1)
        if pat.shape[0] != self.rows * self.cols:
            raise ValueError(
                f"pattern has {pat.shape[0]} cells, lattice has "
                f"{self.rows * self.cols}")
        self.state = torch.as_tensor(np.where(pat, 1.0, -1.0),
                                     dtype=torch.float32, device=self.device)

    def convert_to_numerics(self):
        return self.state.cpu().numpy().reshape(
            self.rows, self.cols).astype(np.int64)

    def convert_to_bools(self):
        return (self.state > 0).cpu().numpy().reshape(self.rows, self.cols)

    def iterate(self, steps=1):
        """``steps`` sequential in-place sweeps: node i's input uses the
        already-updated states of the nodes before it
        (`DiscreteNeuron::update` :280-285: input > 0 -> active, else
        inactive).  The reference sweeps in hash order; the order here is
        row-major: for the symmetric Hopfield weights any sequential order
        descends the energy, where a synchronous sign(W s) update can
        2-cycle forever."""
        s = self.state.clone()
        w = self.weights
        for _ in range(steps):
            for i in range(s.shape[0]):
                inp = torch.dot(s, w[:, i])
                s[i] = torch.where(inp > 0.0, 1.0, -1.0)
        self.state = s

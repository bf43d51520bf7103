"""Genetic algorithm over bitstring chromosomes, batched on the device.

PyTorch counterpart of ``spiking_neural_networks_tpu/fitting/ga.py`` (the
reference's ``backend/src/ga/mod.rs``): the population is a (n_pop,
total_bits) int32 tensor; tournament selection, single-point crossover and
bit-flip mutation are batched tensor operations, and the objective scores
the whole population at once.  The draws come from a `torch.Generator`
in place of a JAX key, and each draw is kept apart from the operator that
uses it (`draw_generation` makes them, `_selection` and
`_crossover_mutate` take them), so the operators can be held against the
JAX package's on the same draws.
"""

from __future__ import annotations

import numpy as np
import torch


class GeneticAlgorithmParameters:
    """`GeneticAlgorithmParameters` (ga/mod.rs:157-190)."""

    def __init__(self, bounds=((0.0, 1.0),), n_bits=8, n_iter=100, n_pop=100,
                 r_cross=0.9, r_mut=0.1, k=3):
        self.bounds = tuple(map(tuple, bounds))
        self.n_bits = n_bits
        self.n_iter = n_iter
        self.n_pop = n_pop
        self.r_cross = r_cross
        self.r_mut = r_mut
        self.k = k
        if n_pop % 2 != 0:
            raise ValueError("population must be even")


def decode_population(bits, bounds, n_bits):
    """`decode` (ga/mod.rs:105-140): each ``n_bits`` substring -> integer
    -> scaled into its (min, max) bound.  ``bits``: (..., n_params *
    n_bits) in {0, 1}; returns (..., n_params) float32 on its device."""
    bounds = torch.as_tensor(np.asarray(bounds, np.float32),
                             device=bits.device)
    n_params = bounds.shape[0]
    b = bits.reshape(bits.shape[:-1] + (n_params, n_bits))
    weights = 2.0 ** torch.arange(n_bits - 1, -1, -1, dtype=torch.float32,
                                  device=bits.device)
    ints = torch.sum(b.to(torch.float32) * weights, dim=-1)
    maximum = 2.0 ** n_bits - 1.0
    lo, hi = bounds[:, 0], bounds[:, 1]
    return lo + (ints / maximum) * (hi - lo)


def draw_generation(generator, n_pop, total_bits, k):
    """One generation's draws on the generator's device: the tournament
    candidates (n_pop, k) in [0, n_pop), the crossover uniforms
    (n_pop // 2, 1), the crossover points (n_pop // 2, 1) in [1,
    total_bits) and the mutation uniforms (n_pop, total_bits)."""
    dev = generator.device
    idx = torch.randint(0, n_pop, (n_pop, k), generator=generator,
                        device=dev)
    u_cross = torch.rand((n_pop // 2, 1), generator=generator, device=dev)
    points = torch.randint(1, total_bits, (n_pop // 2, 1),
                           generator=generator, device=dev)
    u_mut = torch.rand((n_pop, total_bits), generator=generator, device=dev)
    return idx, (u_cross, points, u_mut)


def _selection(idx, scores):
    """Tournament selection (ga/mod.rs:84-100), batched: for each slot the
    lowest-scoring of its drawn candidates ``idx`` (n_pop, k); a tie goes
    to the first candidate."""
    cand_scores = scores[idx]
    best = torch.argmin(cand_scores, dim=1)
    return idx[torch.arange(idx.shape[0], device=idx.device), best]


def _crossover_mutate(parents, draws, r_cross, r_mut):
    """Single-point crossover per pair + i.i.d. bit-flip mutation
    (ga/mod.rs:51-81), batched, on the drawn ``(u_cross, points,
    u_mut)``."""
    u_cross, points, u_mut = draws
    n_pop, total_bits = parents.shape
    pairs = parents.reshape(n_pop // 2, 2, total_bits)
    do_cross = u_cross <= r_cross
    pos = torch.arange(total_bits, device=parents.device)[None, :]
    take_second = (pos >= points) & do_cross
    child1 = torch.where(take_second, pairs[:, 1], pairs[:, 0])
    child2 = torch.where(take_second, pairs[:, 0], pairs[:, 1])
    children = torch.stack([child1, child2], dim=1).reshape(n_pop,
                                                            total_bits)
    flips = u_mut <= r_mut
    return torch.where(flips, 1 - children, children)


def genetic_algo(objective, params, generator=None, verbose=False,
                 device="cuda"):
    """`genetic_algo` (ga/mod.rs:203-272).

    ``objective(decoded)`` takes the decoded (n_pop, n_params) tensor and
    returns (n_pop,) scores to MINIMIZE.  The population lives on the
    device of ``generator`` (a `torch.Generator`), or on ``device`` with
    a generator seeded 0 where None.  The best is replaced only on a
    strictly lower score.  Returns (best_params, best_score, all_scores):
    NumPy parameters, a float and each generation's NumPy scores."""
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    dev = generator.device
    total_bits = params.n_bits * len(params.bounds)
    pop = torch.randint(0, 2, (params.n_pop, total_bits), generator=generator,
                        device=dev, dtype=torch.int32)
    best = None
    best_eval = float("inf")
    all_scores = []
    for gen in range(params.n_iter):
        decoded = decode_population(pop, params.bounds, params.n_bits)
        scores = torch.as_tensor(objective(decoded), device=dev)
        host = scores.cpu().numpy()
        all_scores.append(host)
        gen_best = int(np.argmin(host))
        if float(host[gen_best]) < best_eval:
            best_eval = float(host[gen_best])
            best = decoded[gen_best]
            if verbose:
                print(f"gen {gen + 1}: new best score {best_eval:.6f}")
        idx, draws = draw_generation(generator, params.n_pop, total_bits,
                                     params.k)
        winners = _selection(idx, scores)
        pop = _crossover_mutate(pop[winners], draws, params.r_cross,
                                params.r_mut)
    return (None if best is None else best.cpu().numpy()), best_eval, \
        all_scores

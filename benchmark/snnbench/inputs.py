"""The inputs of a run, drawn from ``--seed`` on the run's device.

The benchmark makes them and hands the same tensors to the port and to
the reference: the stencil's offsets, keep mask and weights, and each
request's initial voltages.  The same seed gives the same inputs in the
same order on the same device.  A traffic kind's ``inputs`` draws them
(`lattice_inputs` for the kinds of one stencil lattice).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

NEVER = -1


def sub_seed(seed, tag):
    """A 63-bit seed for the generator named ``tag`` of run ``seed`` (any
    whole number)."""
    entropy = [int(seed) % 2**64, int(seed) < 0, sum(map(ord, tag)),
               len(tag)] + [ord(c) for c in tag]
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0]) >> 1


def radius_offsets(radius):
    """Every (dr, dc) other than (0, 0) within Euclidean ``radius``,
    row-major (the upstream radius predicate)."""
    r = int(math.ceil(radius))
    return tuple((dr, dc) for dr in range(-r, r + 1)
                 for dc in range(-r, r + 1)
                 if (dr, dc) != (0, 0) and math.hypot(dr, dc) <= radius)


class Graph(NamedTuple):
    """A stencil graph: ``offsets``, the (n_off, rows, cols) float32
    ``weights`` and bool ``mask``, the (rows, cols) float32 ``in_deg``."""
    offsets: tuple
    weights: torch.Tensor
    mask: torch.Tensor
    in_deg: torch.Tensor

    @property
    def masked_slots(self):
        return int(self.mask.sum())

    @property
    def shape(self):
        """The lattice's (rows, cols)."""
        return tuple(self.mask.shape[1:])


def stencil_graph(graph_cfg, rows, cols, seed, device):
    """The configuration's stencil graph at ``rows`` x ``cols``: each
    on-grid edge kept with chance ``keep`` (one draw per edge from the
    seed), weight ``weight``."""
    offsets = radius_offsets(graph_cfg["radius"])
    keep = float(graph_cfg["keep"])
    rr = torch.arange(rows, device=device).reshape(rows, 1)
    cc = torch.arange(cols, device=device).reshape(1, cols)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "graph"))
    draws = torch.rand((len(offsets), rows, cols), generator=gen,
                       device=device)
    planes = []
    for o, (dr, dc) in enumerate(offsets):
        sr, sc = rr + dr, cc + dc
        planes.append((sr >= 0) & (sr < rows) & (sc >= 0) & (sc < cols)
                      & (draws[o] < keep))
    mask = torch.stack(planes)
    weights = torch.where(mask, float(graph_cfg["weight"]), 0.0).to(
        torch.float32)
    in_deg = mask.to(torch.float32).sum(0)
    return Graph(offsets, weights.contiguous(), mask.contiguous(), in_deg)


class VoltageDraws:
    """Each request's initial voltages, uniform in ``[lo, hi)``: (rows,
    cols) float32 planes from the seed's generator on the device, drawn in
    blocks of up to `BLOCK_BYTES` (one launch for many requests, not three
    a request)."""

    BLOCK_BYTES = 64 << 20
    MAX_BLOCK = 256

    def __init__(self, lo, hi, rows, cols, seed, device):
        self.lo, self.span = float(lo), float(hi) - float(lo)
        self.shape = (rows, cols)
        self.device = device
        self.block = max(1, min(self.MAX_BLOCK,
                                self.BLOCK_BYTES // (4 * rows * cols)))
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(sub_seed(seed, "v0"))
        self.planes, self.i = None, self.block

    def next(self):
        if self.i == self.block:
            u = torch.rand((self.block, *self.shape), generator=self.gen,
                           device=self.device)
            self.planes, self.i = u.mul_(self.span).add_(self.lo), 0
        self.i += 1
        return self.planes[self.i - 1]


def lattice_inputs(cfg, traffic, seed, device):
    """``(graph, draws)`` of a run of one stencil lattice: the
    configuration's graph at the traffic's ``rows`` x ``cols``, and the
    requests' initial voltages, uniform in the traffic's ``v0`` range."""
    rows, cols = int(traffic["rows"]), int(traffic["cols"])
    graph = stencil_graph(cfg["graph"], rows, cols, seed, device)
    return graph, VoltageDraws(*traffic["v0"], rows, cols, seed, device)

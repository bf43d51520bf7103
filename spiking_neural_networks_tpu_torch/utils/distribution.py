"""Clamped-normal sampling (`limited_distr`) and Gaussian input noise.

PyTorch counterpart of ``spiking_neural_networks_tpu/utils/
distribution.py``: the reference's ``backend/src/distribution/mod.rs:9-18``
and `GaussianParameters` (iterate_and_spike/mod.rs:2893-2928), drawing
from a `torch.Generator` in place of a JAX key.
"""

from __future__ import annotations

import torch


def limited_distr(generator, mean, std, minimum, maximum, shape=()):
    """Normal(mean, std) float32 samples of ``shape`` from ``generator``
    (a `torch.Generator`, on its device), clamped to [minimum, maximum];
    the mean unclamped where std == 0 (distribution/mod.rs:10-12 returns
    the mean before any clamping)."""
    shape = tuple(shape) if isinstance(shape, (tuple, list)) else (shape,)
    sample = mean + std * torch.randn(shape, generator=generator,
                                      dtype=torch.float32,
                                      device=generator.device)
    clipped = torch.clamp(sample, minimum, maximum)
    if std == 0.0:
        return torch.full_like(clipped, mean)
    return clipped


class GaussianParameters:
    """The reference's noise parameter set (defaults:
    iterate_and_spike/mod.rs:2906-2915)."""

    def __init__(self, mean=1.0, std=0.0, maximum=2.0, minimum=0.0):
        self.mean = mean
        self.std = std
        self.max = maximum
        self.min = minimum

    def sample(self, generator, shape=()):
        return limited_distr(generator, self.mean, self.std, self.min,
                             self.max, shape)

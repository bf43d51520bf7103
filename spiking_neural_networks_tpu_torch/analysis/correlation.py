"""Pearson correlation (the reference's ``backend/src/correlation/mod.rs``).

PyTorch counterpart of ``spiking_neural_networks_tpu/analysis/
correlation.py``.
"""

from __future__ import annotations

import torch


def pearsonr(x, y):
    """`pearsonr` (correlation/mod.rs:19-39) of two series as float32
    tensors (on ``x``'s device where it is a tensor): NaN when either
    series has zero variance, as the reference's division by zero."""
    device = x.device if isinstance(x, torch.Tensor) else None
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    if x.shape != y.shape:
        raise ValueError("series are not the same length")
    xm = x - torch.mean(x)
    ym = y - torch.mean(y)
    numerator = torch.sum(xm * ym)
    denominator = torch.sqrt(torch.sum(xm ** 2) * torch.sum(ym ** 2))
    return numerator / denominator

"""Carrying states and graphs in from NumPy.

The JAX package's arrays become NumPy with ``np.asarray`` on each leaf;
these functions turn such arrays into the PyTorch package's tensors on a
device, keeping every dtype, so that both packages start from the same
numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.graph import StencilGraph


def _tensor(a, device):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def state_from_numpy(state, device):
    """A state dict of tensors on ``device`` from a dict of NumPy arrays."""
    return {k: _tensor(v, device) for k, v in state.items()}


def stencil_graph_from_numpy(offsets, weights, mask, in_deg, device):
    """A `StencilGraph` on ``device`` from its (n_off, rows, cols) weight
    and mask planes and its (rows, cols) in-degree."""
    return StencilGraph(tuple(map(tuple, offsets)),
                        _tensor(np.asarray(weights, np.float32), device),
                        _tensor(np.asarray(mask, bool), device),
                        _tensor(np.asarray(in_deg, np.float32), device))

"""A device mesh: an array of `torch.device` positions with axis names.

`jax.sharding.Mesh` has no plain PyTorch counterpart:
`torch.distributed.device_mesh.DeviceMesh` needs a process group and
cannot name one GPU twice.  `Mesh` is an ndarray of devices with
``axis_names``, where the same device may stand at several positions
(virtual shards: ``[torch.device("cuda:0")] * 4`` runs four row blocks on
one card, ``[torch.device("cpu")] * 8`` eight on the host).  A mesh that
spans processes also records the rank that owns each position; a process
holds only the blocks of its own positions.
"""

from __future__ import annotations

import numpy as np
import torch


def device_array(devices, shape=None):
    """An object ndarray of `torch.device` from any sequence of devices or
    device names, reshaped to ``shape``."""
    flat = [torch.device(d) for d in devices]
    arr = np.empty(len(flat), dtype=object)
    arr[:] = flat
    return arr if shape is None else arr.reshape(shape)


def current_rank():
    """This process's rank where a process group is initialised, else 0."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Mesh:
    """Positions (an object ndarray of `torch.device`) named by
    ``axis_names``; ``ranks``, an int ndarray of the same shape, names the
    process that owns each position (None: this process owns all)."""

    def __init__(self, devices, axis_names, ranks=None):
        if not isinstance(devices, np.ndarray) or devices.dtype != object:
            devices = device_array(list(np.asarray(devices, dtype=object)
                                        .reshape(-1)),
                                   np.shape(devices))
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != devices.ndim:
            raise ValueError(f"{devices.ndim}-D devices need as many axis "
                             f"names, got {self.axis_names}")
        if ranks is not None:
            ranks = np.asarray(ranks, dtype=np.int64)
            if ranks.shape != devices.shape:
                raise ValueError("ranks must have the devices' shape")
        self.ranks = ranks

    @property
    def shape(self):
        """{axis name: size}, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def positions(self):
        """``(device, rank)`` of every position, row-major (rank None on a
        one-process mesh)."""
        ranks = [None] * self.size if self.ranks is None \
            else [int(r) for r in self.ranks.reshape(-1)]
        return list(zip(self.devices.reshape(-1), ranks))

    def spans_processes(self):
        return self.ranks is not None and len(set(self.ranks.reshape(-1))) > 1

    def __repr__(self):
        return f"Mesh({self.shape}, {list(self.devices.reshape(-1))})"

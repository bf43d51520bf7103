"""Meshes across processes (hosts).

PyTorch counterpart of ``spiking_neural_networks_tpu/parallel/
multihost.py``:

* `initialize` starts `torch.distributed` across processes: ``nccl``
  where the local devices are CUDA, ``gloo`` on the CPU;
* `make_hybrid_mesh` lays processes on the outer axis and each process's
  local devices on the inner one (NVLink within a host, the network
  between hosts): the layout whose inner axis carries the
  high-communication traffic.

A lattice sharded over a mesh that spans processes keeps on each process
only the blocks of its own positions; blocks of different processes
exchange their ghost rows with `torch.distributed.batch_isend_irecv`
(`parallel.lattice_sharding`).  On one process `initialize` is a no-op and
the hybrid mesh is (1, n_local).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .mesh import Mesh, device_array

_initialized = False


def _env_int(*names):
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               **kw):
    """Start the process group of a multi-process run.

    The arguments default from the JAX package's variables
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``), then torch's (``MASTER_ADDR`` / ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).  The address is ``host:port`` or a URL;
    ``kw`` goes to `torch.distributed.init_process_group` (``backend``,
    ``timeout``, ...).  A no-op on one host without them, and when a group
    already exists."""
    global _initialized
    import torch.distributed as dist
    if _initialized or dist.is_initialized():
        _initialized = True
        return
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID", "RANK")
    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process run needs the coordinator "
                         "address, the process count and this process's id")
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    kw.setdefault("backend",
                  "nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(init_method=url, world_size=int(num_processes),
                            rank=int(process_id), **kw)
    _initialized = True


def make_hybrid_mesh(dcn_axis="dp", ici_axis="tp", devices=None,
                     prefer_ici=False):
    """A (processes, local devices) mesh: outer axis ``dcn_axis`` across
    processes, inner axis ``ici_axis`` over each process's ``devices``
    (by default its visible CUDA devices; every process passes as many).
    With ``prefer_ici`` a 1-D mesh named ``ici_axis`` in the same order,
    so that neighbouring row blocks of one lattice share a process except
    at the process boundaries."""
    import torch.distributed as dist
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if not devices:
        raise ValueError("no CUDA device: name this process's devices, e.g. "
                         "devices=[torch.device('cpu')] * 2")
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = device_array(devices)
    dev = np.empty((world, len(local)), dtype=object)
    for r in range(world):
        dev[r] = local
    ranks = np.repeat(np.arange(world)[:, None], len(local), axis=1)
    if prefer_ici:
        return Mesh(dev.reshape(-1), (ici_axis,), ranks.reshape(-1))
    return Mesh(dev, (dcn_axis, ici_axis), ranks)

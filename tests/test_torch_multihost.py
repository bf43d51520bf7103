"""The port's meshes across processes (`parallel.multihost`) on the CPU:
two `torch.distributed` processes (``gloo``), two virtual CPU shards each,
build the (2, 2) hybrid mesh and run a row-block sharded lattice whose
ghost rows cross the processes, bit for bit against a process-local run
(tests/_torch_multihost_worker.py, the counterpart of
tests/_multihost_worker.py).  On one process `initialize` is a no-op and
the hybrid mesh is (1, n_local)."""

import os
import socket
import subprocess
import sys

import torch

from spiking_neural_networks_tpu_torch.parallel import (initialize_multihost,
                                                        make_hybrid_mesh)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KEYS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
            "MASTER_ADDR", "WORLD_SIZE", "RANK")


def test_single_host_degrades(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    initialize_multihost()
    assert not torch.distributed.is_initialized()
    cpus = [torch.device("cpu")] * 3
    mesh = make_hybrid_mesh(devices=cpus)
    assert mesh.shape == {"dp": 1, "tp": 3}
    assert not mesh.spans_processes()
    flat = make_hybrid_mesh(devices=cpus, prefer_ici=True)
    assert flat.shape == {"tp": 3}


def test_multihost_two_process():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(__file__),
                          "_torch_multihost_worker.py")
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i}: MULTIHOST_OK" in out

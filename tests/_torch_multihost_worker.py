"""Worker of tests/test_torch_multihost.py: one of two `torch.distributed`
processes (``gloo``, two virtual CPU shards each).  Builds the (2, 2)
hybrid mesh, runs an 8 x 8 radius-2 stencil lattice for 50 steps sharded
over the 4 positions of the 1-D hybrid mesh (its ghost rows crossing the
processes through `batch_isend_irecv`), and checks it bit for bit against
a process-local run.  Imports torch, never jax.

Usage: python _torch_multihost_worker.py <process_id> <num_processes> <port>
"""

import sys

import numpy as np
import torch


def main():
    proc_id, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    import spiking_neural_networks_tpu_torch as snt
    from spiking_neural_networks_tpu_torch.parallel.multihost import (
        initialize, make_hybrid_mesh)
    import torch.distributed as dist
    from datetime import timedelta
    initialize(coordinator_address=f"127.0.0.1:{port}",
               num_processes=nproc, process_id=proc_id,
               timeout=timedelta(seconds=120))
    initialize()  # a second call is a no-op
    assert dist.get_world_size() == nproc
    cpus = [torch.device("cpu")] * 2
    hybrid = make_hybrid_mesh(devices=cpus)
    assert hybrid.shape == {"dp": nproc, "tp": 2}, hybrid.shape

    def build():
        lat = snt.Lattice(snt.Izhikevich(), id=0, device="cpu")
        lat.populate(8, 8, gap_conductance=10.0)
        lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=7)
        v0 = np.random.default_rng(3).uniform(-65, 30, 64).astype(np.float32)
        v0[::7] = 40.0
        lat.apply(lambda s: {**s, "v": torch.from_numpy(v0)})
        return lat

    for use_kernel in (False, True):
        ref = build()
        ref.use_kernel = use_kernel
        ref.run_lattice(50)
        lat = build()
        lat.use_kernel = use_kernel
        lat.shard(make_hybrid_mesh(devices=cpus, prefer_ici=True))
        mine = [b for b in lat.blocks if b.rank == proc_id]
        assert len(mine) == 2 and len(lat.blocks) == 2 * nproc
        lat.run_lattice(50)
        if use_kernel:
            assert lat._last_run_fused[0] == "sharded", lat._last_run_fused
        got = lat.state  # assembled: an all-gather over the processes
        for k in ref.state:
            assert torch.equal(got[k], ref.state[k]), (use_kernel, k)
        assert bool((got["last_firing_time"] >= 0).any())
    dist.destroy_process_group()
    print(f"proc {proc_id}: MULTIHOST_OK", flush=True)


if __name__ == "__main__":
    main()

"""Batched lattices over a (dp, tp) mesh.

PyTorch counterpart of ``spiking_neural_networks_tpu/parallel/
sharding.py``: a batch of B independent lattices of N neurons on dense
(B, N, N) gap-junction weights, with

* **dp** over the batch: each position holds B / dp lattices;
* **tp** over the postsynaptic neurons: a position holds its N / tp
  neurons' state and the (B / dp, N, N / tp) weight columns into them,
  and each step gathers the presynaptic voltages of its dp row from
  every tp position (the all-gather of the column-parallel product).

The STDP weight update of a step is the outer product of the
presynaptic (gathered) and postsynaptic (own) firing times, computed in
the column layout.  A sharded array is a `Blocks`: one tensor per mesh
position on that position's device.  The products are full float32
(`ops.graph.exact_matmul`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.plasticity import STDP, rule_tensors
from ..ops.graph import exact_matmul
from .mesh import Mesh, device_array


def make_mesh(n_devices=None, dp=None, devices=None):
    """A (dp, tp) mesh over ``devices`` (by default the visible CUDA
    devices; raises where fewer than ``n_devices`` exist).  ``dp`` is 2
    where the device count is even and above 2, else 1."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"requested {n_devices} devices but only "
                             f"{len(devices)} available")
        devices = devices[:n_devices]
    n = len(devices)
    if dp is None:
        dp = 2 if (n % 2 == 0 and n > 2) else 1
    if n == 0 or n % dp:
        raise ValueError(f"cannot factor {n} devices into dp={dp}")
    return Mesh(device_array(devices, (dp, n // dp)), ("dp", "tp"))


def state_sharding(mesh):
    """The split of a batched array: (B, N, ...) over ("dp", "tp"), (B,)
    over "dp"."""
    def spec(arr):
        return ("dp", "tp") if arr.dim() >= 2 else ("dp",)
    return spec


def batched_state(model, batch, n, device="cpu", **overrides):
    """A (B, N)-leading state: ``batch`` copies of one lattice's state."""
    s = model.init_state(n, device=device, **overrides)
    return {k: v[None].expand((batch,) + tuple(v.shape)).clone()
            for k, v in s.items()}


def _batched_electrical_gather(v, g_post, weights, mask):
    """``g * (v @ w - v_post * sum_i w) / max(in_deg, 1)`` per lattice of
    the batch, over the masked (B, N_pre, N_post) weights; ``v`` is the
    presynaptic (B, N_pre) voltage, ``g_post`` the postsynaptic
    conductance.  The postsynaptic voltage is ``v`` where N_pre = N_post,
    else the caller's columns (`_column_gather`)."""
    return _column_gather(v, v, g_post, weights, mask)


def _column_gather(v_pre, v_post, g_post, weights, mask):
    w = torch.where(mask, weights, 0.0)
    wa = exact_matmul(v_pre[:, None, :], w)[:, 0]
    wsub = torch.sum(w, dim=1)
    cnt = torch.clamp(torch.sum(mask, dim=1).to(torch.float32), min=1.0)
    return g_post * (wa - v_post * wsub) / cnt


class Blocks:
    """A batched array split over a (dp, tp) mesh: ``parts[(i, j)]`` is
    position (i, j)'s block, on its device; ``spec`` names the axes split
    (("dp", "tp"): batch and neurons; ("dp", None, "tp"): batch and the
    weights' post columns; ("dp",): batch)."""

    def __init__(self, mesh, parts, spec):
        self.mesh, self.parts, self.spec = mesh, parts, spec

    def whole(self, device=None):
        """The array assembled on ``device`` (the first position's)."""
        dp, tp = self.mesh.devices.shape
        device = device or self.mesh.devices[0, 0]
        if "tp" not in self.spec:
            return torch.cat([self.parts[(i, 0)].to(device)
                              for i in range(dp)])
        dim = self.spec.index("tp")
        return torch.cat([torch.cat([self.parts[(i, j)].to(device)
                                     for j in range(tp)], dim=dim)
                          for i in range(dp)])


def _split(mesh, x, spec):
    """``x`` cut into a `Blocks` of ``spec``, a copy on each position."""
    dp, tp = mesh.devices.shape
    b = x.shape[0] // dp
    parts = {}
    for i in range(dp):
        for j in range(tp):
            part = x[i * b:(i + 1) * b]
            if "tp" in spec:
                dim = spec.index("tp")
                n = x.shape[dim] // tp
                part = part.narrow(dim, j * n, n)
            parts[(i, j)] = part.to(mesh.devices[i, j], copy=True) \
                .contiguous()
    return Blocks(mesh, parts, spec)


def shard_batched_inputs(mesh, state, weights, mask):
    """The mesh's `Blocks` of a batched state dict and of the (B, N, N)
    weights and mask (split on batch and post columns)."""
    spec = state_sharding(mesh)
    state = {k: _split(mesh, v, spec(v)) for k, v in sorted(state.items())}
    return (state, _split(mesh, weights, ("dp", None, "tp")),
            _split(mesh, mask, ("dp", None, "tp")))


def make_sharded_training_step(mesh, model):
    """The one-step function over the mesh and the rule it applies:
    ``step(state, weights, mask, clock, pparams) -> (state, weights,
    spikes)`` on `Blocks` (`shard_batched_inputs`), ``pparams`` the STDP
    parameters (floats or 0-dim tensors).  A step: each position gathers
    its dp row's presynaptic voltages, takes its columns' electrical
    input, steps its neurons, stamps their firing times with ``clock``,
    then updates its weight columns by STDP from the gathered
    presynaptic and its own postsynaptic firing times and spikes, one
    visit per spiking endpoint, on the masked edges."""
    stdp = STDP()
    dp, tp = mesh.devices.shape
    tensors = {}

    def rule_on(pparams, dev):
        """The rule's parameters as 0-dim tensors on ``dev``, made once
        per device and parameter set (each is a host-to-device copy)."""
        key = (str(dev),) + tuple(sorted((k, float(v))
                                         for k, v in pparams.items()))
        if key not in tensors:
            tensors[key] = rule_tensors(dict(key[1:]), dev)
        return tensors[key]

    def row(blocks, i, device):
        return torch.cat([blocks.parts[(i, j)].to(device)
                          for j in range(tp)], dim=1)

    def step(state, weights, mask, clock, pparams):
        new_state = {k: dict(v.parts) for k, v in state.items()}
        spikes, new_w = {}, {}
        for (i, j), dev in np.ndenumerate(mesh.devices):
            s = {k: v.parts[(i, j)] for k, v in state.items()}
            v_pre = row(state["v"], i, dev)
            elec = _column_gather(v_pre, s["v"], s["gap_conductance"],
                                  weights.parts[(i, j)], mask.parts[(i, j)])
            s, spk = model.step(s, elec, skip_nt=True)
            s["last_firing_time"] = s["last_firing_time"].masked_fill(
                spk, int(clock))
            for k, v in s.items():
                new_state[k][(i, j)] = v
            spikes[(i, j)] = spk
        new_state = {k: Blocks(mesh, p, state[k].spec)
                     for k, p in new_state.items()}
        spk_blocks = Blocks(mesh, spikes, ("dp", "tp"))
        for (i, j), dev in np.ndenumerate(mesh.devices):
            p = rule_on(pparams, dev)
            lft_pre = row(new_state["last_firing_time"], i, dev)
            spk_pre = row(spk_blocks, i, dev)
            lft = new_state["last_firing_time"].parts[(i, j)]
            spk = spikes[(i, j)]
            pre = {"last_firing_time": lft_pre[:, :, None],
                   "is_spiking": spk_pre[:, :, None]}
            post = {"last_firing_time": lft[:, None, :],
                    "is_spiking": spk[:, None, :]}
            count = spk_pre[:, :, None].to(torch.float32) \
                + spk[:, None, :].to(torch.float32)
            w = weights.parts[(i, j)]
            w_new = STDP.apply_visits(w, pre, post, p, count)
            new_w[(i, j)] = torch.where(mask.parts[(i, j)], w_new, w)
        return new_state, Blocks(mesh, new_w, weights.spec), spk_blocks

    return step, stdp

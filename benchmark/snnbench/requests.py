"""Drivers of the port's lattice entries, which the traffic kinds under
``traffic/kinds/`` build on: each builds the port's system from a
configuration and the benchmark's graph, and serves one request at a time.

Requests are a closed loop, as a script makes them: each call waits for
its readout on the host before the next one starts.  Each request is one
trial: the lattice starts again from the state ``populate`` gives it, the
benchmark's graph and the request's own initial voltages (drawn from the
seed), so every request does the same work and its answer can be
recomputed from the benchmark's inputs alone.

* `LatticeRun`: ``run_lattice(steps)`` of the configuration's ``system``;
  readout the neurons that fired and the mean voltage;
* `RewardRun`: ``RewardModulatedLattice.run_lattice_with_reward(reward,
  steps)``; readout the dopamine, the summed weight and the neurons that
  fired.
"""

from __future__ import annotations

import contextlib

import torch


def _span(tracing, name):
    return torch.profiler.record_function(name) if tracing \
        else contextlib.nullcontext()


class LatticeRun:
    """``Lattice`` (a configuration with ``system`` "Lattice") or
    ``RewardModulatedLattice`` driven by ``run_lattice`` requests."""

    def __init__(self, snt, cfg, traffic, graph, device):
        self.cfg, self.traffic = cfg, traffic
        self.rows, self.cols = int(traffic["rows"]), int(traffic["cols"])
        self.steps = int(traffic["steps"])
        self.neurons = self.rows * self.cols
        self.device = torch.device(device)
        self.lat = self._build(snt, cfg, graph)
        self.tracing = False

    def _build(self, snt, cfg, graph):
        lat = getattr(snt, cfg["system"])(getattr(snt, cfg["model"])(),
                                          device=self.device)
        lat.populate(self.rows, self.cols, **cfg["neuron"])
        self.port_graph = snt.StencilGraph(graph.offsets, graph.weights,
                                           graph.mask, graph.in_deg)
        lat.graph = self.port_graph
        lat.use_kernel = True
        self.base = dict(lat.state)
        return lat

    def _start(self, v0):
        self.lat.state = dict(self.base, v=v0.reshape(-1))
        self.lat.internal_clock = 0

    def _call(self):
        self.lat.run_lattice(self.steps)

    def _readout(self):
        st = self.lat.state
        got = torch.stack([(st["last_firing_time"] >= 0).sum().double(),
                           st["v"].mean(dtype=torch.float64)]).tolist()
        return {"fired": got[0], "mean_v": got[1]}

    def route_ok(self):
        """Whether the last request took the kernel route the
        configuration is benchmarked on."""
        return self.lat._last_run_fused == ("kernel", False)

    def request(self, v0):
        """One request from the initial voltages ``v0``; returns its
        readout on the host."""
        with _span(self.tracing, "request"):
            with _span(self.tracing, "reset"):
                self._start(v0)
            with _span(self.tracing, "run"):
                self._call()
            with _span(self.tracing, "readout"):
                return self._readout()

    def snapshot(self):
        """Copies of what the last request produced, for the check."""
        st = self.lat.state
        return {"v": st["v"].reshape(self.rows, self.cols).clone(),
                "w": st["w"].reshape(self.rows, self.cols).clone(),
                "lft": st["last_firing_time"].reshape(
                    self.rows, self.cols).clone()}


class RewardRun(LatticeRun):
    """``RewardModulatedLattice.run_lattice_with_reward`` requests."""

    def _build(self, snt, cfg, graph):
        lat = super()._build(snt, cfg, graph)
        lat.reward_modulator = snt.RewardModulatedSTDP(**cfg["rstdp"])
        self.trace0 = {"c": torch.zeros_like(graph.weights),
                       "dw": torch.zeros_like(graph.weights),
                       "counter": torch.zeros(graph.weights.shape,
                                              dtype=torch.int32,
                                              device=self.device)}
        return lat

    def _start(self, v0):
        super()._start(v0)
        self.lat.graph = self.port_graph
        self.lat.trace = dict(self.trace0)
        self.lat.dopamine = 0.0

    def _call(self):
        self.lat.run_lattice_with_reward(float(self.traffic["reward"]),
                                         self.steps)

    def _readout(self):
        st = self.lat.state
        got = torch.stack([self.lat.graph.weights.sum(dtype=torch.float64),
                           (st["last_firing_time"] >= 0).sum().double()
                           ]).tolist()
        return {"dopamine": float(self.lat.dopamine), "weight_sum": got[0],
                "fired": got[1]}

    def route_ok(self):
        return self.lat._last_run_fused is True

    def snapshot(self):
        out = super().snapshot()
        tr = self.lat.trace
        out.update(weights=self.lat.graph.weights.clone(),
                   c=tr["c"].clone(), dw=tr["dw"].clone(),
                   counter=tr["counter"].clone(),
                   dopamine=torch.tensor(self.lat.dopamine,
                                         dtype=torch.float32))
        return out

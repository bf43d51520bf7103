"""Shared tools of the science-pipeline tests
(``tests/test_torch_experiments_memory.py``,
``tests/test_torch_experiments_space.py``): the JAX scripts of
``experiments/`` against their counterparts in
``spiking_neural_networks_tpu_torch/experiments/`` on the CPU.

* `Recorder` patches both packages' core `LatticeNetwork.run_lattices`:
  it keeps each network at its first run with a snapshot of what was built
  (every lattice's and train's state, each lattice's weights as a dense
  matrix, each connection's COO arrays), forces the port's ``use_kernel``
  and records, run by run, the route the port took
  (``_last_run_fused``) and the verdict of the JAX package's gate
  (`ops.pallas_reward.plain_network_runner`, asked with `resolve_pallas`
  forced on; its spec is read and the XLA runner then runs as on the CPU);
  with ``force``, every train's chance of firing is raised to 1 where it
  is above 0 before each run (`force_chances`).
* `LatticeRecorder` does the same for single lattices (``run_lattice``
  of a `Lattice` or a `RewardModulatedLattice`, ``run_lattice_with_reward``)
  and reward networks (a step of the host-loop `Environment`): the JAX
  lattice gate is asked through its runner factory (`core.lattice.
  _build_lattice_runner`, the verdict recorded, the XLA runner built), the
  R-STDP lattice's through `pallas_reward.lattice_run` and the reward
  network's through `pallas_reward.network_runner` (both asked, then
  declined, so the XLA runner runs as on the CPU).
* `assert_built_equal`, `assert_histories_close`: the network edge for
  edge, the trajectories within a tolerance.
"""

import contextlib
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(ROOT, "experiments") not in sys.path:
    sys.path.insert(0, os.path.join(ROOT, "experiments"))

from spiking_neural_networks_tpu.core import lattice as jlattice  # noqa: E402
from spiking_neural_networks_tpu.core import network as jnetwork  # noqa: E402
from spiking_neural_networks_tpu.core import reward as jreward  # noqa: E402
from spiking_neural_networks_tpu.core import \
    reward_structured as jrs  # noqa: E402
from spiking_neural_networks_tpu.core import structured as jst  # noqa: E402
from spiking_neural_networks_tpu.ops import pallas_reward as jpr  # noqa: E402

from spiking_neural_networks_tpu_torch.core import \
    lattice as tlattice  # noqa: E402
from spiking_neural_networks_tpu_torch.core import \
    network as tnetwork  # noqa: E402
from spiking_neural_networks_tpu_torch.core import \
    reward as treward  # noqa: E402
from spiking_neural_networks_tpu_torch.core import \
    reward_network as treward_network  # noqa: E402
from spiking_neural_networks_tpu_torch.experiments import \
    pipeline_setup  # noqa: E402


def spec_tag(spec):
    """The port's route name for a network spec of either package."""
    flat = any(ls.graph == "dense" for ls in spec.lattices) \
        or any(c.op[0] == "dense" for c in spec.conns)
    if flat:
        return "flat-chemical" if spec.chem else "flat"
    return "chemical" if spec.chem else "network"


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def snapshot(net, graph_to_coo):
    """What ``net`` (either package's core `LatticeNetwork`) holds before
    its first run: states, dense lattice weights, connections."""
    lats = {}
    for i, lat in net.lattices.items():
        src, dst, w, _ = graph_to_coo(lat.graph)
        dense = np.zeros((lat.n, lat.n), np.float32)
        dense[_host(src), _host(dst)] = _host(w)
        lats[i] = ({k: _host(v).copy() for k, v in lat.state.items()
                    if not k.startswith("_")}, dense)
    trains = {i: {k: _host(v).copy() for k, v in st.state.items()
                  if not k.startswith("_")}
              for i, st in net.spike_train_lattices.items()}
    conns = {}
    for key, c in net.connections.items():
        conns[key] = tuple(_host(a).copy() for a in c[:3])
    return dict(lattices=lats, trains=trains, connections=conns)


def force_chances(net, to_array):
    """Every spike train's chance of firing of ``net`` (either package's
    core network) raised to 1 where it is above 0: the draws then fire
    alike in both packages."""
    for st in net.spike_train_lattices.values():
        if "chance_of_firing" in st.state:
            c = _host(st.state["chance_of_firing"])
            st.state = {**st.state, "chance_of_firing": to_array(
                np.where(c > 0, 1.0, 0.0).astype(np.float32))}


class Recorder:
    """Records the networks and routes of both packages' runs (see the
    module docstring).  ``use_kernel`` is set on every port network
    before it runs (None: the CPU's plain route; True: the kernel route's
    twin; False: plain)."""

    def __init__(self, monkeypatch, use_kernel=None, force=False):
        self.use_kernel = use_kernel
        self.jax, self.torch = [], []          # (net, snapshot)
        self.jax_routes, self.torch_routes = [], []
        self.jax_steps = []
        rec = self

        jrun = jnetwork.LatticeNetwork.run_lattices
        trun = tnetwork.LatticeNetwork.run_lattices

        def jax_run(net, n):
            if not any(net is x for x, _ in rec.jax):
                rec.jax.append((net, snapshot(net, jnetwork._graph_to_coo)))
            rec.jax_steps.append(int(n))
            if force:
                force_chances(net, lambda c: jnp.asarray(c))
            return jrun(net, n)

        def torch_run(net, n):
            if not any(net is x for x, _ in rec.torch):
                rec.torch.append((net, snapshot(net,
                                                tnetwork._graph_to_coo)))
            if force:
                force_chances(net, lambda c: torch.as_tensor(
                    c, device=next(iter(net.lattices.values())).device))
            net.use_kernel = rec.use_kernel
            out = trun(net, n)
            rec.torch_routes.append(net._last_run_fused)
            return out

        gate = jpr.plain_network_runner

        def jax_gate(*a, **k):
            specs = []
            with monkeypatch.context() as m:
                m.setattr(jpr, "_build_fused_plain_runner",
                          lambda spec, *b, **c: specs.append(spec) or spec)
                out = gate(*a, **k)
            rec.jax_routes.append(spec_tag(specs[0]) if out is not None
                                  else False)
            return None             # the XLA runner, as on the CPU

        monkeypatch.setattr(jnetwork.LatticeNetwork, "run_lattices", jax_run)
        monkeypatch.setattr(tnetwork.LatticeNetwork, "run_lattices",
                            torch_run)
        monkeypatch.setattr(jst, "resolve_pallas", lambda s: True)
        monkeypatch.setattr(jpr, "plain_network_runner", jax_gate)

    def routes(self):
        """The port's route names, run by run (False: plain)."""
        return [r[0] if r else False for r in self.torch_routes]


def lattice_tag(route):
    """A lattice route of either package by kernel family: ``"stencil"``
    (JAX True / ("multi", ...) / ("tiled", ...); port ("kernel", emit)),
    ``"stdp"``, ``"model"``, ``"hh"``, ``"reward"`` (an R-STDP lattice or
    network on its kernel) or False (plain)."""
    if route is True:
        return "stencil"
    if not route:
        return False
    head = route[0] if isinstance(route, tuple) else route
    return {"multi": "stencil", "tiled": "stencil",
            "kernel": "stencil"}.get(head, head)


def lattice_snapshot(lat, graph_to_coo):
    """A lattice's state and dense weights before its first run."""
    src, dst, w, _ = graph_to_coo(lat.graph)
    dense = np.zeros((lat.n, lat.n), np.float32)
    dense[_host(src), _host(dst)] = _host(w)
    return ({k: _host(v).copy() for k, v in lat.state.items()
             if not k.startswith("_")}, dense)


class LatticeRecorder:
    """Records the single lattices and reward networks of both packages'
    runs and each run's route (module docstring); ``use_kernel`` is set on
    every port lattice and network before it runs."""

    def __init__(self, monkeypatch, use_kernel=None):
        self.use_kernel = use_kernel
        self.jax, self.torch = [], []          # (lattice, snapshot)
        self.jax_routes, self.torch_routes = [], []
        rec = self

        def keep(where, lat, graph_to_coo):
            if not any(lat is x for x, _ in where):
                where.append((lat, lattice_snapshot(lat, graph_to_coo)))

        def jax_chunk(orig):
            def run(lat, *a, **k):
                keep(rec.jax, lat, jnetwork._graph_to_coo)
                return orig(lat, *a, **k)
            return run

        def torch_run(orig, reward=False):
            def run(lat, *a, **k):
                keep(rec.torch, lat, tnetwork._graph_to_coo)
                lat.use_kernel = rec.use_kernel
                out = orig(lat, *a, **k)
                route = lat._last_run_fused
                rec.torch_routes.append(
                    ("reward" if route else False) if reward
                    else lattice_tag(route))
                return out
            return run

        build = jlattice._build_lattice_runner

        def jax_build(*a, **k):
            # ``use_pallas`` is the factory's 12th parameter
            args = list(a)
            if len(args) > 11:
                rec.jax_routes.append(lattice_tag(args[11]))
                args[11] = False
            else:
                rec.jax_routes.append(lattice_tag(k.get("use_pallas")))
                k["use_pallas"] = False
            return build(*args, **k)

        def jax_lattice_run(lat, rewards, with_reward):
            rec.jax_routes.append("reward")
            return False                # the XLA runner, as on the CPU

        rrun = jreward.RewardModulatedLattice._run

        def jax_reward_run(lat, rewards, with_reward):
            keep(rec.jax, lat, jnetwork._graph_to_coo)
            n = len(rec.jax_routes)
            out = rrun(lat, rewards, with_reward)
            if len(rec.jax_routes) == n:
                rec.jax_routes.append(False)
            return out

        net_runner = jpr.network_runner

        def jax_network_runner(net, *a, **k):
            with monkeypatch.context() as m:
                m.setattr(jpr, "_build_fused_network_runner",
                          lambda *b, **c: "reward")
                out = net_runner(net, *a, **k)
            rec.jax_routes.append("reward" if out is not None else False)
            return None

        monkeypatch.setattr(tlattice.Lattice, "_run_chunk",
                            torch_run(tlattice.Lattice._run_chunk))
        monkeypatch.setattr(treward.RewardModulatedLattice, "_run",
                            torch_run(treward.RewardModulatedLattice._run,
                                      reward=True))
        monkeypatch.setattr(jlattice.Lattice, "_run_chunk",
                            jax_chunk(jlattice.Lattice._run_chunk))
        monkeypatch.setattr(jlattice, "resolve_pallas", lambda s: True)
        monkeypatch.setattr(jlattice, "_build_lattice_runner", jax_build)
        monkeypatch.setattr(jreward, "resolve_pallas", lambda s: True)
        monkeypatch.setattr(jreward.RewardModulatedLattice, "_run",
                            jax_reward_run)
        monkeypatch.setattr(jpr, "lattice_run", jax_lattice_run)
        monkeypatch.setattr(jrs, "resolve_pallas", lambda s: True)
        monkeypatch.setattr(jpr, "network_runner", jax_network_runner)

        trun = treward_network.RewardModulatedLatticeNetwork \
            .run_lattices_with_reward

        def torch_reward_net(net, *a, **k):
            net.use_kernel = rec.use_kernel
            out = trun(net, *a, **k)
            rec.torch_routes.append(lattice_tag(net._last_run_fused))
            return out

        monkeypatch.setattr(treward_network.RewardModulatedLatticeNetwork,
                            "run_lattices_with_reward", torch_reward_net)

    def routes(self):
        return list(self.torch_routes)


@contextlib.contextmanager
def kernel(rec, use_kernel):
    saved = rec.use_kernel
    rec.use_kernel = use_kernel
    try:
        yield rec
    finally:
        rec.use_kernel = saved


def assert_built_equal(jsnap, tsnap):
    """Edge for edge and state for state (every field the JAX network
    holds)."""
    assert sorted(jsnap["lattices"]) == sorted(tsnap["lattices"])
    assert sorted(jsnap["trains"]) == sorted(tsnap["trains"])
    assert list(jsnap["connections"]) == list(tsnap["connections"])
    for key, arrays in jsnap["connections"].items():
        for a, b in zip(arrays, tsnap["connections"][key]):
            np.testing.assert_array_equal(b, a, err_msg=str(key))
    for i, (state, dense) in jsnap["lattices"].items():
        tstate, tdense = tsnap["lattices"][i]
        np.testing.assert_array_equal(tdense, dense, err_msg=f"weights {i}")
        for k, v in state.items():
            if k in tstate:
                np.testing.assert_array_equal(tstate[k], v,
                                              err_msg=f"{k} of {i}")
    for i, state in jsnap["trains"].items():
        for k, v in state.items():
            if k in tsnap["trains"][i]:
                np.testing.assert_array_equal(tsnap["trains"][i][k], v,
                                              err_msg=f"{k} of train {i}")


def history(lat):
    """A lattice's grid history as one (T, ...) array (either package's
    core lattice)."""
    return np.stack([_host(h) for h in lat.grid_history.history])


def max_dv(jlat, tlat, upto=None):
    hj, ht = history(jlat)[:upto], history(tlat)[:upto]
    assert hj.shape == ht.shape, (hj.shape, ht.shape)
    assert np.isfinite(ht).all()
    return float(np.abs(hj.astype(np.float64) - ht).max(initial=0.0))


def assert_histories_close(jlat, tlat, mv=2.0, steps=2, upto=None):
    """Every step of the grid histories within ``mv`` and the last firing
    times within ``steps``."""
    dv = max_dv(jlat, tlat, upto)
    assert dv <= mv, dv
    lj = _host(jlat.state["last_firing_time"]).astype(np.int64)
    lt = _host(tlat.state["last_firing_time"]).astype(np.int64)
    if upto is None:
        assert ((lj < 0) == (lt < 0)).all()
        assert np.abs(lj - lt).max(initial=0) <= steps
    return dv


FORCED, FREE = "forced", "free"


def BAND(a, b):
    """Two free runs' firing counts (independent draws of one chance)
    agree when they differ by at most three standard deviations of a
    Poisson difference, plus 3."""
    return abs(a - b) <= 3 * math.sqrt(a + b) + 3


def outputs_to(monkeypatch, tmp_path, *mods):
    for mod in mods:
        monkeypatch.setattr(mod, "output_path",
                            lambda name: str(tmp_path / os.path.basename(
                                name)))


def run_three(rec, jax_fn, torch_fn):
    """The JAX run, then the port's kernel route and its plain route."""
    jv = jax_fn()
    with kernel(rec, True):
        kv = torch_fn()
    with kernel(rec, False):
        pv = torch_fn()
    return jv, kv, pv


def check_routes(rec, want):
    """Both gates took ``want`` on every run; the port's plain runs took
    the plain route."""
    n = len(rec.jax_routes)
    assert rec.jax_routes == [want] * n
    assert rec.routes() == [want] * n + [False] * n


def spikes(lat):
    """Steps a neuron's voltage peaks above 20 mV (the pipelines' own
    spike measure), summed over a lattice's history."""
    hist = history(lat).reshape(len(lat.grid_history.history), -1)
    return sum(len(pipeline_setup.find_peaks_above_threshold(hist[:, i], 20))
               for i in range(hist.shape[1]))


def trains_fired(net):
    return sum(int(_host(s.state["last_firing_time"] >= 0).sum())
               for s in net.spike_train_lattices.values())


def check_runs(rec, ids, mode, upto=None):
    """The port's two runs against the JAX run: built equal; ``FORCED``:
    2 mV / 2 steps over the whole run; ``FREE``: 1e-4 mV over the first
    ``upto`` steps, then the firing counts within `BAND`."""
    (jnet, jsnap), runs = rec.jax[0], rec.torch
    assert len(runs) == 2
    for tnet, tsnap in runs:
        assert_built_equal(jsnap, tsnap)
        for i in ids:
            if mode == FORCED:
                assert_histories_close(jnet.lattices[i], tnet.lattices[i])
            else:
                if upto:
                    assert max_dv(jnet.lattices[i], tnet.lattices[i],
                                     upto) <= 1e-4
                assert BAND(spikes(jnet.lattices[i]),
                            spikes(tnet.lattices[i]))
        if mode == FREE:
            assert BAND(trains_fired(jnet), trains_fired(tnet))
        else:
            assert trains_fired(jnet) == trains_fired(tnet)
        for lat in tnet.lattices.values():
            for v in lat.state.values():
                if v.is_floating_point():
                    assert torch.isfinite(v).all()

"""The port's step timer and profiler trace (`spiking_neural_networks_
tpu_torch.utils.profiling`) on the CPU: `StepTimer` on a lattice and on a
network (neuron counts as the JAX package's), and `trace` writing a
Chrome trace file."""

import json
import os

import numpy as np
import pytest
import torch

import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu_torch.utils.profiling import (StepTimer,
                                                               trace)

torch.set_num_threads(1)


def test_step_timer_on_a_lattice():
    lat = snt.Lattice(snt.Izhikevich(), device="cpu")
    lat.populate(4, 4, gap_conductance=10.0)
    lat.connect_stencil(radius=1.5)
    r = StepTimer(lat).measure(iterations=50)
    assert r["steps_per_sec"] > 0 and r["neuron_updates_per_sec"] > 0
    assert r["neuron_updates_per_sec"] == pytest.approx(
        16 * r["steps_per_sec"])
    assert lat.internal_clock == 100            # the warm-up and the run
    with pytest.raises(ValueError):
        StepTimer(lat).measure(iterations=0)


def test_step_timer_on_a_reward_network():
    from test_torch_checkpoint import poisson_net, reward_net
    net, _ = poisson_net()
    t = StepTimer(net)
    assert t.neurons() == 32
    r = t.measure(iterations=20, warmup=False)
    assert net.internal_clock == 20
    assert r["neuron_updates_per_sec"] == pytest.approx(
        32 * r["steps_per_sec"])
    rnet = reward_net()
    assert StepTimer(rnet).neurons() == 8
    assert StepTimer(rnet).measure(iterations=5)["step_time_us"] > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    lat = snt.Lattice(snt.Izhikevich(), device="cpu")
    lat.populate(4, 4, gap_conductance=10.0)
    lat.connect_stencil(radius=1.5)
    d = tmp_path / "trace"
    with trace(str(d)) as tr:
        lat.run_lattice(5)
        assert tr.profile is not None and tr.path is None
    assert tr.log_dir == str(d) and os.path.dirname(tr.path) == str(d)
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert np.isfinite(lat.voltages()).all()

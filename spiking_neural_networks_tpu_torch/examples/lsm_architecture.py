"""Liquid state machine skeleton (the reference's
`backend/examples/lsm_architecture/main.rs`): a Poisson input row sparsely
drives a 10x10 recurrent Izhikevich liquid, which feeds a 4x2
reward-modulated readout layer (feedforward row-to-row edges carrying
R-STDP eligibility traces).  A host-loop `Environment`
(interactable/mod.rs:21-60) pulses the Poisson cue every 2000 steps, pays
reward on the pulse steps, and records the network's dopamine trace; the
readout's weight + voltage grid histories are collected like the
reference's `weights.txt`/`voltage.txt`.

This keeps the reference's host-driven `Environment` because the encoder
branches on the integer clock; see `examples/agent_environment.py` /
`interactable.JitEnvironment` for the fused whole-episode form.  PyTorch
counterpart of ``examples/lsm_architecture.py``, on ``device`` (``"cuda"``
by default).

Run: python -m spiking_neural_networks_tpu_torch.examples.lsm_architecture
[--device cpu]"""

import numpy as np
import torch

import spiking_neural_networks_tpu_torch as snn
from ..interactable import Environment
from . import device_main


def main(iterations=10000, period=2000, seed=0, device="cuda"):
    rng = np.random.default_rng(seed)

    poisson_input = snn.SpikeTrainLattice(snn.PoissonSpikeTrain(), id=0,
                                          device=device)
    poisson_input.populate(1, 10)
    poisson_input.update_grid_history = True

    liquid = snn.Lattice(snn.Izhikevich(), id=1, device=device)
    liquid.populate(10, 10)
    # radius-4 sparse recurrent pool, 40% keep (the reference's
    # sparse_connect); could be normalized to spectral radius 1
    liquid.connect(lambda x, y: np.hypot(x[0] - y[0], x[1] - y[1]) <= 4.0
                   and rng.random() <= 0.4 and x != y)
    liquid.apply(lambda s: {**s, "v": torch.as_tensor(
        rng.uniform(-65.0, 30.0, 100), dtype=torch.float32,
        device=liquid.device)})

    readout = snn.RewardModulatedLattice(snn.Izhikevich(), id=2,
                                         device=device)
    readout.populate(4, 2)
    readout.connect(lambda x, y: y[0] - x[0] == 1,
                    lambda x, y: float(rng.uniform(0.1, 0.5)))
    readout.apply(lambda s: {**s, "v": torch.as_tensor(
        rng.uniform(-65.0, 30.0, 8), dtype=torch.float32,
        device=readout.device)})
    readout.do_modulation = True
    readout.update_graph_history = True
    readout.update_grid_history = True

    lsm = snn.RewardModulatedLatticeNetwork()
    lsm.add_lattice(liquid)
    lsm.add_lattice(readout)
    lsm.add_spike_train_lattice(poisson_input)
    lsm.connect(0, 1, lambda x, y: rng.random() < 0.05)
    lsm.connect_with_reward_modulation(
        1, 2, lambda x, y: y[0] == 0 and rng.random() < 0.05,
        lambda x, y: 2.0)

    class LsmState:
        def __init__(self):
            self.timestep = 0
            self.dopamine_history = []

        def update_state(self, network):
            self.timestep = network.internal_clock
            self.dopamine_history.append(network.dopamine)

    def reward_function(state, agent):
        on = state.timestep % period == 0 and state.timestep != 0
        return 1.0 if on else 0.0

    def state_encoder(state, agent):
        t = state.timestep
        if t % period == 0 and t != 0:
            rate = 0.025
        elif t % period == period // 4 or t == 0:
            rate = 0.0
        else:
            return
        agent.get_spike_train_lattice(0).apply(
            lambda s: {**s, "chance_of_firing":
                       torch.full_like(s["chance_of_firing"], rate)})

    env = Environment(lsm, LsmState(), state_encoder, reward_function)
    env.run_with_reward(iterations)

    dop = np.asarray(env.state.dopamine_history)
    weights = env.agent.get_reward_modulated_lattice(2).graph_history
    volts = np.asarray(
        env.agent.get_reward_modulated_lattice(2).grid_history.history)
    print(f"dopamine: {len(dop)} steps, peak {dop.max():.3f}, "
          f"final {dop[-1]:.4f}")
    w0, w1 = np.asarray(weights[0]), np.asarray(weights[-1])
    moved = float(np.abs(w1 - w0).max())
    print(f"readout weights: {len(weights)} snapshots, max |dw| {moved:.4f}")
    print(f"readout voltage history {volts.shape}, range "
          f"[{volts.min():.2f}, {volts.max():.2f}] mV")
    return env


def cli(argv=None):
    """The command line: `main` on ``--device``."""
    return device_main(main, argv)


if __name__ == "__main__":
    cli()

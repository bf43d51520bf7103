"""Reward-driven agent in a closed-loop environment — fused on device.

PyTorch counterpart of ``examples/agent_environment.py``, on ``device``
(``"cuda"`` by default).  Demonstrates the `Environment`/`Agent` protocol
(the reference's `backend/src/interactable/mod.rs:21-60`): a
reward-modulated Izhikevich lattice is the agent; the environment's state
tracks the lattice's firing rate; the reward pushes the firing rate toward
a target by dopamine-modulating the recurrent weights (R-STDP).

Unlike the reference's per-step host loop, `JitEnvironment` runs the WHOLE
episode on the agent's device — reward computation, R-STDP agent update,
state update, cue encoding — with no host round trip inside a call: on a
GPU as replays of a CUDA graph of 16 closed-loop steps around the
hand-written kernel's step launches (tier (a)), where the callbacks can be
captured.

The environment keeps its cue key as a leaf, as the JAX script does: the
update advances it each step and the encoder draws the 6 cued neurons of
100 without replacement from it (`cue_indices`, a counter-based draw: the
same neurons on every device, captured into the graph with the other
leaves; the JAX script draws them with `jax.random.choice`, so the two
packages cue other neurons).

Run: python -m spiking_neural_networks_tpu_torch.examples.agent_environment
[--device cpu]
"""

import numpy as np
import torch

import spiking_neural_networks_tpu_torch as snn
from ..convert import env_from
from ..interactable import JitEnvironment
from . import device_main

TARGET_RATE = 0.08      # fraction of neurons spiking per step


def reward_fn(env, s):
    # proportional control toward the target rate; the sign of the reward
    # (via dopamine) gates whether the eligibility traces strengthen or
    # weaken the recurrent weights
    return torch.clamp(env["target"] - env["rate"], -0.05, 0.05)


def update_fn(env, s):
    spiking = s["is_spiking"].to(torch.float32).mean()
    return {**env, "rate": 0.9 * env["rate"] + 0.1 * spiking,
            "key": env["key"]}


def cue_indices(key, n, k):
    """``k`` of ``n`` positions without replacement, a function of the
    integer-valued ``key`` alone: each position's 32-bit counter ``key * n
    + i`` passes an integer hash (xor-shift and odd multiply, a bijection
    of the 32-bit integers, in int64 without overflow) and the ``k``
    smallest are cued."""
    x = key.to(torch.int64) * n + torch.arange(n, device=key.device)
    for _ in range(2):
        x = ((x ^ (x >> 16)) * 0x45D9F3B) & 0xFFFFFFFF
    x = x ^ (x >> 16)
    return torch.argsort(x, stable=True)[:k]


def encoder_fn(env, s):
    # random cue: a fresh subset fires every step; the recurrent weights
    # (shaped by R-STDP) determine how far the activity spreads beyond it
    idx = cue_indices(env["key"], 100, 6)
    return {**s, "v": s["v"].index_fill(0, idx, 31.0)}


def encoder_key_fn(env, s):
    """update_state advances the cue key so encoder_fn sees a fresh draw."""
    return {**env, "key": env["key"] + 1.0}


def main(iterations=1500, device="cuda"):
    agent = snn.RewardModulatedLattice(snn.Izhikevich(), device=device)
    agent.populate(10, 10, gap_conductance=10.0)
    agent.connect(lambda x, y: np.hypot(x[0] - y[0], x[1] - y[1]) <= 2
                  and x != y,
                  lambda x, y: 2.0)
    rng = np.random.default_rng(0)
    agent.apply(lambda s: {**s, "v": torch.as_tensor(
        rng.uniform(-65, 30, 100), dtype=torch.float32, device=agent.device)})

    def update_state(env, s):
        return encoder_key_fn(update_fn(env, s), s)

    env = JitEnvironment(
        agent,
        env_from({"rate": 0.0, "target": TARGET_RATE, "key": 3.0}, device),
        encoder_fn, reward_fn, update_state)

    def weight_drift():
        g = agent.graph
        return float(torch.where(g.mask, g.weights - 2.0, 0.0).abs().max())

    w_start = weight_drift()
    rates = []
    for chunk in range(10):
        env.run_with_reward(iterations // 10)
        rates.append(float(env.state["rate"]))
    w_mid = weight_drift()

    # flip the objective: an over-target setpoint makes the reward negative,
    # reversing the dopamine-gated drift
    env.state = {**env.state,
                 "target": torch.full_like(env.state["target"], -1.0)}
    for chunk in range(10):
        env.run_with_reward(iterations // 10)
        rates.append(float(env.state["rate"]))
    w_end = weight_drift()

    print("firing-rate trajectory:", " ".join(f"{r:.3f}" for r in rates))
    print(f"max |recurrent weight drift|: start {w_start:.3f} -> after "
          f"+reward {w_mid:.3f} -> after -reward {w_end:.3f}")
    print("reward-gated plasticity moved weights:", w_mid > w_start)
    return rates


def cli(argv=None):
    """The command line: `main` on ``--device``."""
    return device_main(main, argv)


if __name__ == "__main__":
    cli()

"""Traffic kind ``closed_loop``: ``JitEnvironment.run_with_reward(steps)``
episodes of an R-STDP lattice at the mix's ``rows`` x ``cols`` and the
environment of its ``env``: a cue holding the first ``cue_neurons`` neurons
at ``cue_mv``, the reward ``clip(target_rate - rate, -clip, clip)``, and
``rate = keep * rate + take * mean spike``.  Each episode starts from its
own initial voltages (uniform in the mix's ``v0``), zero traces, zero
dopamine and rate 0; readout the per-step rewards.  The reference's
``closed_loop`` recomputes an episode, and `numbers` compares the
episode's rewards and rate beside the configuration's state; a call's least
time is the R-STDP step's count."""

import math

import torch

from snnbench import counts, inputs as _inputs, requests


class Runner(requests.RewardRun):
    """``JitEnvironment.run_with_reward`` requests of an R-STDP lattice."""

    def __init__(self, snt, cfg, traffic, graph, device):
        super().__init__(snt, cfg, traffic, graph, device)
        env = traffic["env"]
        cue = torch.arange(self.neurons, device=self.device) \
            < int(env["cue_neurons"])
        cue_mv, target = float(env["cue_mv"]), float(env["target_rate"])
        clip, keep, take = (float(env[k]) for k in ("clip", "keep", "take"))

        def encoder(e, s):
            return {**s, "v": torch.where(cue, cue_mv, s["v"])}

        def reward(e, s):
            return torch.clamp(target - e["rate"], -clip, clip)

        def update(e, s):
            return {"rate": keep * e["rate"]
                    + take * s["is_spiking"].to(torch.float32).mean()}

        self.rate0 = torch.zeros((), dtype=torch.float32, device=self.device)
        self.env = snt.interactable.JitEnvironment(
            self.lat, {"rate": self.rate0.clone()}, encoder, reward, update)
        self.rewards = None

    def _start(self, v0):
        super()._start(v0)
        self.env.state = {"rate": self.rate0.clone()}

    def _call(self):
        self.rewards = self.env.run_with_reward(self.steps)

    def _readout(self):
        return {"rewards": [float(r) for r in self.rewards]}

    def route_ok(self):
        want = self.device.type == "cuda"
        return (self.env.last_build_fused
                and self.env.last_build_env_fused is want)

    def snapshot(self):
        out = super().snapshot()
        out.update(rewards=torch.as_tensor(self.rewards),
                   rate=self.env.state["rate"].clone())
        return out


def numbers(prog, ref):
    """The loop's own compared numbers: ``rewards_gap``, the largest gap of
    a step's reward, and ``rate_gap``, the gap of the environment's
    rate."""
    gap = (prog["rewards"].float().to(ref["rewards"].device)
           - ref["rewards"].float()).abs()
    return {"rewards_gap": float(gap.max()) if bool(
                torch.isfinite(gap).all()) else math.inf,
            "rate_gap": abs(float(prog["rate"]) - float(ref["rate"]))}


inputs = _inputs.lattice_inputs


def call_least(cfg, traffic, graph):
    """Least seconds of one `counts.CALL_STEPS`-step call."""
    return counts.lp_call_least(*graph.shape, graph.offsets,
                                graph.masked_slots)

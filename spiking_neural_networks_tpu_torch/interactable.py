"""Agent / environment loops for reward-driven simulation.

PyTorch counterpart of ``spiking_neural_networks_tpu/interactable.py``.
`RewardModulatedLattice` implements the Agent protocol
(`update_and_apply_reward` / `update`); `Lattice` implements the
unsupervised one (`update` = one step).  `Environment` and
`UnsupervisedEnvironment` are the host loops over that protocol;
`JitEnvironment` runs the whole closed loop on the agent's device, with
callbacks that are PyTorch functions on the agent's flat (N,) state dict:

- ``reward_function(env, s)`` returns a 0-dim tensor;
- ``update_state(env, s)`` returns the env;
- ``state_encoder(env, s)`` returns the state dict (it may write any of
  the state's fields; ``v`` drives the next step).

``env`` is a tree of dicts, lists and tuples whose leaves are tensors on
the agent's device (`convert.env_from` makes one from the JAX package's).
Per step: reward from the previous state, then the agent's step (dopamine,
cell step, plasticity), then ``update_state`` and ``state_encoder`` on the
post-step state.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.history import (HISTORY_KINDS, history_step_bytes,
                           resolve_history_chunk)
from .core.sharded import shard_of
from .ops import reward_kernels as rk
from .utils import profiling

# the state fields that live in the kernel's (rows, cols) planes
PLANE_KEYS = ("v", "w", "last_firing_time", "refractory_count",
              "is_spiking")


def _agent_history_chunk(agent):
    """The history chunk of a `JitEnvironment` agent
    (`core.history.resolve_history_chunk`; None = auto)."""
    bps = 0
    if agent.update_grid_history:
        bps += history_step_bytes(agent.grid_history.kind, agent.n)
    if getattr(agent, "update_graph_history", False):
        bps += 4 * int(agent.graph.weights.numel())
    return resolve_history_chunk(agent.history_chunk, bps)


class Environment:
    """`Environment` (interactable/mod.rs:21-60): agent + state + encoders.

    - ``state_encoder(state, agent)``: writes the environment state into the
      agent (e.g. sets spike-train rates / input currents).
    - ``reward_function(state, agent) -> float``: computes the reward.
    """

    def __init__(self, agent, state, state_encoder, reward_function=None):
        self.agent = agent
        self.state = state
        self.state_encoder = state_encoder
        self.reward_function = reward_function

    def run_with_reward(self, iterations):
        """`Environment::run_with_reward` (interactable/mod.rs:33-46)."""
        if self.reward_function is None:
            raise ValueError("run_with_reward requires a reward_function")
        for _ in range(iterations):
            reward = self.reward_function(self.state, self.agent)
            self.agent.update_and_apply_reward(reward)
            self.state.update_state(self.agent)
            self.state_encoder(self.state, self.agent)

    def run(self, iterations):
        """`Environment::run` (interactable/mod.rs:48-59)."""
        for _ in range(iterations):
            self.agent.update()
            self.state.update_state(self.agent)
            self.state_encoder(self.state, self.agent)


class UnsupervisedEnvironment(Environment):
    """The same loop without a reward (interactable/mod.rs:63-97)."""

    def __init__(self, agent, state, state_encoder):
        super().__init__(agent, state, state_encoder, reward_function=None)


def _flatten(tree):
    """``(leaves, treedef)`` of a tree of dicts (keys sorted), lists and
    tuples; anything else is a leaf."""
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        parts = [_flatten(tree[k]) for k in keys]
        return ([x for leaves, _ in parts for x in leaves],
                ("dict", keys, tuple(d for _, d in parts)))
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(x) for x in tree]
        return ([x for leaves, _ in parts for x in leaves],
                (type(tree).__name__, None, tuple(d for _, d in parts)))
    return [tree], None


def _unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, children = d
        vals = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(keys, vals))
        return vals if kind == "list" else tuple(vals)

    return build(treedef)


def _freeze(hist):
    """Hashable signature of a history readout."""
    if hasattr(hist, "reference_voltage"):
        return (hist.kind, hist.reference_voltage, hist.distance,
                hist.conductivity)
    return (hist.kind,)


def _put(dst, src):
    """Copy ``src`` (a tensor or a number) into the buffer ``dst``, unless
    it is that buffer already."""
    if not isinstance(src, torch.Tensor):
        dst.fill_(src)
    elif src.data_ptr() != dst.data_ptr() or src.shape != dst.shape:
        if src.numel() != dst.numel():
            raise ValueError(f"a tensor of shape {tuple(src.shape)} cannot "
                             f"replace one of shape {tuple(dst.shape)}")
        dst.copy_(src.reshape(dst.shape))


class _KernelLoop:
    """The kernel tiers of one closed loop: buffers that are the agent's
    state between calls, the launches of `reward_kernels.
    env_step_launcher` from each of two plane sets into the other, their
    `reward_kernels.EnvChain` (on a GPU a step's edge pass runs in the
    next step's launch, and `flush` runs the last one), and on a GPU the
    CUDA graph of `STEPS_PER_LAUNCH` steps and a flush."""

    def __init__(self, env, spec, rule, treedef, leaves):
        agent = env.agent
        st = agent.state
        dev = st["v"].device
        # the callbacks, not the env: no reference cycle keeps a dropped
        # loop's graph alive until a garbage collection, which may fall in
        # the middle of another loop's capture
        self.callbacks = (env.reward_function, env.update_state,
                          env.state_encoder)
        self.spec, self.rule, self.treedef = spec, rule, treedef
        self.shape = (agent.rows, agent.cols)
        self.cuda = dev.type == "cuda"
        f32, i32 = torch.float32, torch.int32
        plane = lambda dt: torch.zeros(self.shape, dtype=dt, device=dev)
        refractory = spec.model in rk.REFRACTORY_MODELS
        self.planes = [(plane(f32), plane(f32), plane(i32),
                        plane(f32) if refractory else None)
                       for _ in range(2)]
        self.spikes = plane(torch.bool)
        self.other = {k: x.clone() for k, x in st.items()
                      if k not in PLANE_KEYS}
        g = agent.graph
        self.weights = torch.empty_like(g.weights)
        self.mask = torch.empty_like(g.mask)
        self.in_deg = torch.empty_like(g.in_deg)
        self.traces = tuple(torch.empty_like(agent.trace[k])
                            for k in ("c", "dw", "counter")) \
            if spec.kind == "mod" else None
        self.dopamine = torch.zeros((), dtype=f32, device=dev)
        self.clock = torch.zeros(1, dtype=i32, device=dev)
        self.rew = torch.zeros(rk.STEPS_PER_LAUNCH, dtype=f32, device=dev)
        self.leaves = [torch.empty_like(x, device=dev)
                       if isinstance(x, torch.Tensor) else
                       torch.empty((), dtype=torch.as_tensor(x).dtype,
                                   device=dev) for x in leaves]
        params = {k: self.other[k].view(self.shape)
                  for k in rk.MODEL_PARAM_KEYS[spec.model]}
        self.chain = rk.EnvChain(self.dopamine, self.clock, self.shape)
        self.launch = [rk.env_step_launcher(
            spec, self.planes[p], self.planes[1 - p], self.spikes,
            self.weights, self.mask, self.in_deg, params, self.traces,
            self.dopamine, rule, self.clock, self.chain) for p in (0, 1)]
        has = set(st)
        self.views = []
        for v, w, lft, refr in self.planes:
            d = dict(self.other)
            d.update({"v": v.view(-1), "w": w.view(-1),
                      "last_firing_time": lft.view(-1),
                      "is_spiking": self.spikes.view(-1)})
            if refr is not None:
                d["refractory_count"] = refr.view(-1)
            self.views.append({k: x for k, x in d.items() if k in has})
        self.parity = 0
        self.graph = None
        self.graph_launches = 0    # the kernel launches of one replay
        # the probe's verdict (the callbacks can be captured), None before
        # the first probe
        self.capture_ok = None

    def state_buffers(self):
        """The buffers that hold the loop's state between calls."""
        return ([x for pl in self.planes for x in pl if x is not None]
                + [self.spikes, self.weights, self.dopamine, self.clock,
                   self.rew] + list(self.traces or ()) + self.leaves
                + list(self.other.values()))

    def buffers(self):
        """Every buffer a step may write: the state's and the chain's."""
        return self.state_buffers() + self.chain.buffers()

    def load(self, agent, leaves):
        """Copy the agent's state, graph, traces, dopamine and clock and the
        env's leaves into the buffers (plane set 0)."""
        st = agent.state
        for key, buf in zip(("v", "w", "last_firing_time",
                             "refractory_count"), self.planes[0]):
            if buf is None:
                continue
            if key in st:
                _put(buf, st[key])
            else:
                buf.zero_()
        _put(self.spikes, st["is_spiking"])
        for k, buf in self.other.items():
            _put(buf, st[k])
        g = agent.graph
        for buf, x in ((self.weights, g.weights), (self.mask, g.mask),
                       (self.in_deg, g.in_deg)):
            _put(buf, x)
        if self.traces is not None:
            for buf, k in zip(self.traces, ("c", "dw", "counter")):
                _put(buf, agent.trace[k])
        self.dopamine.fill_(getattr(agent, "dopamine", 0.0))
        self.clock.fill_(agent.internal_clock)
        for buf, x in zip(self.leaves, leaves):
            _put(buf, x)
        self.parity = 0
        self.chain.reset()

    def store(self, agent):
        """Hand the buffers to the agent as its state, weights and
        traces."""
        agent.state = dict(self.views[self.parity])
        if self.spec.kind != "plain":
            agent.graph = agent.graph.replace_weights(self.weights)
        if self.traces is not None:
            agent.trace = dict(zip(("c", "dw", "counter"), self.traces))

    def step(self, slot):
        """One closed-loop step; the reward goes into the 0-dim ``slot``."""
        with profiling.span("loop.step"):
            self._step(slot)

    def _step(self, slot):
        (reward_fn, update_fn, encoder), p = self.callbacks, self.parity
        tree = _unflatten(self.treedef, self.leaves)
        if self.spec.with_reward:
            r = reward_fn(tree, dict(self.views[p]))
            _put(slot, r)
        self.launch[p](slot)
        view = self.views[1 - p]
        s = dict(view)
        tree = update_fn(tree, s)
        leaves, treedef = _flatten(tree)
        if treedef != self.treedef:
            raise ValueError("update_state changed the structure of the "
                             "environment's tree")
        enc = dict(encoder(tree, s))
        if set(enc) != set(view):
            raise ValueError("state_encoder must return the state's keys, "
                             f"{sorted(view)}; got {sorted(enc)}")
        for k, x in enc.items():
            if x is not view[k]:
                if tuple(x.shape) != tuple(view[k].shape):
                    raise ValueError(f"state_encoder changed the shape of "
                                     f"{k!r}")
                view[k].copy_(x)
        for buf, x in zip(self.leaves, leaves):
            _put(buf, x)
        self.parity = 1 - p

    def flush(self):
        """Settle the last step's edge pass and the scalars."""
        with profiling.span("loop.flush"):
            self.chain.flush()

    def probe(self):
        """Run one step and a flush on a snapshot of the buffers and of the
        default random generators, restored after, on a GPU on a side
        stream with
        PyTorch's host syncs turned into errors: the warm-up before a
        capture, and False if a callback synchronizes with the host (the
        loop then runs without a graph).  A callback's own generator is
        advanced by the step."""
        saved = [b.clone() for b in self.buffers()]
        parity = self.parity
        dev = self.rew.device
        with torch.random.fork_rng(
                devices=[dev] if dev.type == "cuda" else []):
            try:
                if not self.cuda:
                    self.step(self.rew[0])
                    self.flush()
                    return True
                main = torch.cuda.current_stream()
                side = torch.cuda.Stream()
                side.wait_stream(main)
                mode = torch.cuda.get_sync_debug_mode()
                try:
                    with torch.cuda.stream(side):
                        torch.cuda.set_sync_debug_mode("error")
                        self.step(self.rew[0])
                        self.flush()
                except RuntimeError as e:
                    if isinstance(e, rk.KernelError) \
                            or "synchroniz" not in str(e):
                        raise
                    return False
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
                    main.wait_stream(side)
                return True
            finally:
                for b, x in zip(self.buffers(), saved):
                    b.copy_(x)
                self.parity = parity
                self.chain.reset()

    def capture(self):
        """Capture `STEPS_PER_LAUNCH` steps (an even count, so a replay
        starts and ends on plane set 0 and slot 0) and a flush into a CUDA
        graph, and count its kernel launches."""
        graph = torch.cuda.CUDAGraph()
        parity, launched = self.parity, self.chain.launched
        try:
            with torch.cuda.graph(graph):
                for k in range(rk.STEPS_PER_LAUNCH):
                    self.step(self.rew[k])
                self.flush()
        finally:
            self.parity = parity
            self.chain.reset()
        self.graph = graph
        self.graph_launches = self.chain.launched - launched


class _Plan:
    """One call's route and results between `JitEnvironment._begin`,
    `_advance` and `_finish`."""

    def __init__(self, length, with_reward, readout, loop, graph):
        self.length, self.with_reward = length, with_reward
        self.readout, self.loop, self.graph = readout, loop, graph
        self.rewards, self.ys = None, []


class JitEnvironment:
    """The closed loop on the agent's device: the reference's
    `run_with_reward` / `run` iteration (interactable/mod.rs:33-59) with
    the environment state a tree of tensors and three tensor callbacks
    (module docstring).  The agent is a `RewardModulatedLattice`
    (`run_with_reward`) or a plain `Lattice` (`run`).

    Three tiers, chosen per call:

    (a) env-fused: the agent passes `reward_kernels.supports_lattice`
        (`supports_plain_lattice` for `run`), no history is on, and the
        callbacks pass a probe (no host sync): on a GPU a call of n steps
        replays a CUDA graph of K = `STEPS_PER_LAUNCH` closed-loop steps
        and a flush n // K times and runs the rest step by step, then a
        flush; each step runs the reward callback, one launch of the
        hand-written kernel of an `reward_kernels.env_step_launcher` step
        (the previous step's edge pass, then this step; reward, dopamine
        and clock in device memory) and the update and encoder callbacks;
        a flush runs the last step's edge pass: K + 1 launches per K steps
        with plasticity;
    (b) per-step kernel: the same steps without a graph, for a grid
        history (read out per step), callbacks that cannot be captured,
        a call of fewer than K steps, or the CPU (the twin, which runs
        each step whole);
    (c) plain route: `reward_lattice_step` / `lattice_step` per step, for
        ``use_kernel=False`` or an agent outside the kernel's class.

    ``agent.use_kernel`` None takes the kernel tiers on a GPU, True also
    on the CPU (tier (b), with the kernels' plain twin in each step),
    False never.  ``last_build_fused`` says that the last call took tier
    (a) or (b), ``last_build_env_fused`` that it took tier (a): a graph
    replayed.  Nothing returns to the host inside a call but the
    final pull of rewards, dopamine, clock and history; a kernel failure
    raises.
    """

    def __init__(self, agent, state, state_encoder, reward_function,
                 update_state):
        self.agent = agent
        self.state = state
        self.state_encoder = state_encoder
        self.reward_function = reward_function
        self.update_state = update_state
        # kernel-tier loops by (route, callbacks, env structure); bounded,
        # since each holds its buffers and, on a GPU, a graph and its pool
        self._runners = {}
        self._runners_max = 8
        self.last_build_fused = False
        self.last_build_env_fused = False
        # why the last failed capture failed (tier (b) then), or None
        self.last_capture_error = None

    def _cache(self, key, runner):
        """Insert into the bounded runner cache (FIFO eviction)."""
        if len(self._runners) >= self._runners_max:
            self._runners.pop(next(iter(self._runners)))
        self._runners[key] = runner
        return runner

    def _readout(self, hist_sig):
        if hist_sig is None:
            return None
        cls = HISTORY_KINDS[hist_sig[0]]
        return cls(*hist_sig[1:]) if len(hist_sig) > 1 else cls()

    def _hist_sig(self):
        agent = self.agent
        if getattr(agent, "update_graph_history", False):
            raise ValueError(
                "JitEnvironment does not record graph (weight) histories; "
                "use the host-loop Environment for those")
        if getattr(agent, "update_grid_history", False):
            return _freeze(agent.grid_history)
        return None

    def _kernel_spec(self, with_reward):
        """The kernel's `LatSpec` for this agent, or None (plain route)."""
        agent = self.agent
        use = getattr(agent, "use_kernel", None)
        if use is False:
            return None
        if with_reward:
            if not rk.supports_lattice(agent):
                return None
            kind = "mod" if agent.do_modulation else "plain"
        else:
            if not rk.supports_plain_lattice(agent):
                return None
            kind = "plastic" if agent.do_plasticity else "plain"
        if use is None and not agent.state["v"].is_cuda:
            return None
        return rk.LatSpec(kind, rk.model_kind(agent.model),
                          agent.graph.offsets, with_reward=with_reward)

    def run_with_reward(self, iterations):
        """Run ``iterations`` closed-loop steps; returns the per-step
        rewards (a host float32 array).  Grid / EEG histories are recorded
        when ``agent.update_grid_history`` is set (chunked as the lattice
        runners chunk them)."""
        if self.reward_function is None:
            raise ValueError("run_with_reward requires a reward_function")
        return self._run(iterations, True)

    def run(self, iterations):
        """The unsupervised loop: agent step -> state update -> encoder per
        step; the agent is a plain `Lattice`."""
        self._run(iterations, False)

    def _run(self, iterations, with_reward):
        if shard_of(self.agent) is not None:
            # every tier steps the agent's whole state on one device
            raise ValueError(
                "JitEnvironment does not run a sharded agent; use the "
                "host-loop Environment, whose steps run its blocks")
        with profiling.span("loop.run"):
            hist_sig = self._hist_sig()
            chunk = _agent_history_chunk(self.agent) \
                if hist_sig is not None else int(iterations)
            out, remaining = [], int(iterations)
            while remaining > 0:
                length = min(remaining, chunk)
                plan = self._begin(length, with_reward, hist_sig)
                self._advance(plan)
                out.append(self._finish(plan))
                remaining -= length
        if with_reward:
            return np.concatenate(out) if out \
                else np.zeros((0,), np.float32)
        return None

    def _begin(self, length, with_reward, hist_sig):
        """Choose the tier, build or fetch its loop and load the state: the
        part of a call that may wait for the device (the gate reads the
        neurotransmitter mask; a capture synchronizes)."""
        with profiling.span("loop.begin"):
            self.last_build_fused = self.last_build_env_fused = False
            agent = self.agent
            readout = self._readout(hist_sig)
            spec = self._kernel_spec(with_reward)
            if spec is None:
                return _Plan(length, with_reward, readout, None, False)
            rule = agent.reward_modulator.params if with_reward \
                else agent.plasticity.params if spec.kind == "plastic" else {}
            leaves, treedef = _flatten(self.state)
            key = (spec, (agent.rows, agent.cols),
                   str(agent.state["v"].device),
                   tuple(sorted((k, float(v)) for k, v in rule.items())),
                   tuple(sorted((k, tuple(x.shape), x.dtype)
                                for k, x in agent.state.items())),
                   self.reward_function if with_reward else None,
                   self.update_state, self.state_encoder, treedef,
                   tuple((tuple(np.shape(x)), getattr(x, "dtype", type(x)))
                         for x in leaves))
            loop = self._runners.get(key)
            if loop is None:
                loop = self._cache(key, _KernelLoop(self, spec, rule, treedef,
                                                    leaves))
            with profiling.span("loop.load"):
                loop.load(agent, leaves)
            graph = False
            if hist_sig is None:
                K = rk.STEPS_PER_LAUNCH
                want = loop.cuda and loop.graph is None and length >= K
                if loop.capture_ok is None or (loop.capture_ok and want):
                    with profiling.span("loop.probe"):
                        loop.capture_ok = loop.probe()
                if loop.capture_ok and want:
                    try:
                        with profiling.span("loop.capture"):
                            loop.capture()
                    except rk.KernelError:
                        raise
                    except Exception as e:
                        # e.g. a callback drawing from a generator that is not
                        # registered with the graph: tier (b), and it says so
                        self.last_capture_error = repr(e)
                        loop.capture_ok = False
                # tier (a) only where a graph replays in this call
                graph = bool(loop.capture_ok and loop.graph is not None
                             and length >= K)
            self.last_build_fused, self.last_build_env_fused = True, graph
            return _Plan(length, with_reward, readout, loop, graph)

    def _advance(self, plan):
        """The steps of a call, on the device; nothing returns to the host
        (on the kernel tiers, as the smoke checks)."""
        if plan.loop is None:
            return self._advance_plain(plan)
        loop, n = plan.loop, plan.length
        dev = loop.rew.device
        rewards = torch.empty(n, dtype=torch.float32, device=dev)
        done = 0
        if plan.graph:
            K = rk.STEPS_PER_LAUNCH
            while n - done >= K:
                with profiling.span("loop.replay"):
                    loop.graph.replay()
                rk.ENV_LAUNCHES += loop.graph_launches
                if plan.with_reward:
                    rewards[done:done + K].copy_(loop.rew)
                done += K
        for i in range(done, n):
            loop.step(rewards[i])
            if plan.readout is not None:
                plan.ys.append(plan.readout.readout(
                    loop.views[loop.parity], loop.shape).clone())
        loop.flush()
        plan.rewards = rewards

    def _advance_plain(self, plan):
        from .core.lattice import lattice_step
        from .core.plasticity import rule_tensors
        from .core.reward import reward_lattice_step
        agent = self.agent
        st, graph, env = agent.state, agent.graph, self.state
        dev = st["v"].device
        with profiling.span("wait.nt_mask"):
            skip_nt = not bool(st["nt$mask"].any())
        clock = agent.internal_clock
        shape = (agent.rows, agent.cols)
        rewards = []
        if plan.with_reward:
            pparams = rule_tensors(agent.reward_modulator.params, dev)
            trace = agent.trace
            dop = torch.tensor(agent.dopamine, dtype=torch.float32,
                               device=dev)
        else:
            pparams = rule_tensors(agent.plasticity.params, dev)
        for _ in range(plan.length):
            if plan.with_reward:
                r = self.reward_function(env, st)
                r = r if isinstance(r, torch.Tensor) else torch.tensor(
                    r, dtype=torch.float32, device=dev)
                st, graph, trace, dop, clock = reward_lattice_step(
                    agent.model, agent.electrical_synapse,
                    agent.chemical_synapse, agent.do_modulation, True,
                    skip_nt, pparams, st, graph, trace, dop, clock, r)
                rewards.append(r.to(torch.float32).reshape(()))
            else:
                st, graph, clock = lattice_step(
                    agent.model, agent.electrical_synapse,
                    agent.chemical_synapse, bool(agent.do_plasticity),
                    skip_nt, agent.plasticity, pparams, st, graph, clock)
            env = self.update_state(env, st)
            st = dict(self.state_encoder(env, st))
            if plan.readout is not None:
                plan.ys.append(plan.readout.readout(st, shape))
        agent.state, agent.graph = st, graph
        agent.internal_clock = clock
        if plan.with_reward:
            agent.trace = trace
            plan.dopamine = dop
            plan.rewards = torch.stack(rewards)
        self.state = env

    def _finish(self, plan):
        """Hand the results to the agent and the env, with one pull of the
        rewards, dopamine and clock, and of the history, to the host."""
        with profiling.span("loop.finish"):
            agent = self.agent
            if plan.readout is not None:
                agent.grid_history.extend(torch.stack(plan.ys).cpu())
            if plan.loop is None:
                if not plan.with_reward:
                    return None
                with profiling.span("wait.loop_pull"):
                    got = torch.cat([plan.rewards,
                                     plan.dopamine.reshape(1)]).cpu()
                agent.dopamine = float(got[-1])
                return got[:-1].numpy()
            loop = plan.loop
            loop.store(agent)
            self.state = _unflatten(loop.treedef,
                                    [x.clone() for x in loop.leaves])
            # float64 holds the float32 rewards and dopamine and the int32
            # clock exactly: one transfer
            got = torch.cat([plan.rewards, loop.dopamine.reshape(1)]).double()
            with profiling.span("wait.loop_pull"):
                got = torch.cat([got, loop.clock.double()]).cpu()
            agent.internal_clock = int(got[-1])
            if plan.with_reward:
                agent.dopamine = float(got[-2])
                return got[:-2].numpy().astype(np.float32)
            return None

"""Compile parsed `.nb` blocks into PyTorch model classes.

PyTorch counterpart of ``spiking_neural_networks_tpu/dsl/builder.py``:
the definition compiles to a :class:`NeuronModel` /
:class:`SpikeTrainModel` subclass of the port whose step interprets the
parsed statements over the state's tensors.

Semantics preserved from the reference's codegen (``nb_macro``
``src/lib.rs``):

* ``v`` -> membrane potential, ``i`` -> input current; injected defaults
  current_voltage=0, dt=0.1, c_m=1, gap_conductance=10.
* ``dX/dt = expr`` computes ``dX = expr * dt`` in statement order and
  applies all deltas after the statement list, each accumulated as
  ``0.0 + delta``.
* ``r^`` is the clipped power ``max(x, 0) ^ p``.
* electrochemical template: receptor kinetics update -> receptor currents
  from pre-update v -> on_iteration -> ``v -= get_receptor_currents`` ->
  neurotransmitter update -> spike handling.

One interpreter, two backends.  `eval_expr` and `run_statements` take
their operations (the constant maker, ``where``, the logical operations
and the function table) from the env's ``"__ops__"``: `TorchOps` computes
on tensors, and the emitter of ``ops/dsl_kernels.py`` takes symbolic
values through the same code and records each operation as a line of
CUDA C, so the generated kernel repeats the twin's operations in the
twin's order by construction.  A number is a 0-dim float32 tensor on the
state's device, never a Python float: ``scalar / x`` is computed as
``reciprocal(x) * scalar`` by torch, which rounds differently from the
division the kernel makes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import parser as P
from ..models.base import TORCH_FNS, NeuronModel
from ..models.spike_train import REFRACTORINESS, SpikeTrainModel
from ..ops import kinetics as K
from ..ops.receptors import ReceptorSystem

# the DSL's builtin functions, by name: the `Fns` field that computes each
# (a model step's `fns`), else the torch function
FNS_FIELDS = {"exp": "exp", "ln": "log", "log": "log", "log10": "log10",
              "tanh": "tanh", "sinh": "sinh", "cosh": "cosh", "sqrt": "sqrt",
              "sin": "sin", "cos": "cos", "tan": "tan"}
TORCH_FUNCTIONS = {"abs": torch.abs, "floor": torch.floor,
                   "ceil": torch.ceil, "min": torch.minimum,
                   "max": torch.maximum}


@functools.lru_cache(maxsize=4096)
def _const(value, device):
    return torch.tensor(value, dtype=torch.float32, device=device)


def _is_bool(x):
    if isinstance(x, torch.Tensor):
        return x.dtype == torch.bool
    return isinstance(x, bool)


class TorchOps:
    """The interpreter's operations on tensors of ``device``, with the
    transcendental functions of ``fns`` (a `models.base.Fns`)."""

    def __init__(self, fns=TORCH_FNS, device="cpu"):
        self.fns = fns
        self.device = str(device)

    def num(self, value):
        """A DSL number: a 0-dim float32 tensor on the device."""
        return _const(float(value), self.device)

    def _t(self, x):
        return x if isinstance(x, torch.Tensor) else self.num(x)

    def cond(self, c):
        """``c`` as a condition: nonzero is true, as ``jnp.where`` reads
        a float."""
        if _is_bool(c):
            return c
        return self._t(c) != 0.0

    def where(self, c, a, b):
        c = self.cond(c)
        if isinstance(c, bool):
            return a if c else b
        return torch.where(c, a, b)

    def logical_and(self, a, b):
        a, b = self.cond(a), self.cond(b)
        if isinstance(a, bool) and isinstance(b, bool):
            return a and b
        return torch.logical_and(self._b(a), self._b(b))

    def logical_or(self, a, b):
        a, b = self.cond(a), self.cond(b)
        if isinstance(a, bool) and isinstance(b, bool):
            return a or b
        return torch.logical_or(self._b(a), self._b(b))

    def logical_not(self, a):
        a = self.cond(a)
        return (not a) if isinstance(a, bool) else torch.logical_not(a)

    def _b(self, x):
        return x if isinstance(x, torch.Tensor) \
            else torch.tensor(x, device=self.device)

    def pow(self, a, b):
        return self.fns.pow(self._t(a), self._t(b))

    def maximum(self, a, b):
        return torch.maximum(self._t(a), self._t(b))

    def call(self, name, args):
        """The builtin function ``name`` of ``args``, or None where the
        DSL has no such builtin."""
        if name == "heaviside":
            return (self._t(args[0]) > 0.0).to(torch.float32)
        field = FNS_FIELDS.get(name)
        fn = getattr(self.fns, field) if field else TORCH_FUNCTIONS.get(name)
        if fn is None:
            return None
        return fn(*[self._t(a) for a in args])


def ops_for(x, fns=TORCH_FNS):
    """The backend of a value: the emitter's, for its symbolic values
    (they carry it as ``dsl_ops``), else `TorchOps` on its device."""
    ops = getattr(x, "dsl_ops", None)
    if ops is not None:
        return ops
    return TorchOps(fns, x.device if isinstance(x, torch.Tensor) else "cpu")


def eval_expr(expr, env):
    ops = env["__ops__"]
    if isinstance(expr, P.Num):
        return ops.num(expr.value)
    if isinstance(expr, P.Var):
        name = expr.name
        if name == "true":
            return True
        if name == "false":
            return False
        if name not in env:
            raise NameError(f"unknown variable {name!r} in DSL expression")
        return env[name]
    if isinstance(expr, P.Unary):
        val = eval_expr(expr.operand, env)
        if expr.op == "-":
            return -val
        return ops.logical_not(val)
    if isinstance(expr, P.BinOp):
        a = eval_expr(expr.left, env)
        b = eval_expr(expr.right, env)
        op = expr.op
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return a / b
        if op == "^":
            return ops.pow(a, b)
        if op == "r^":  # clipped power (nb_macro/src/lib.rs:136)
            return ops.pow(ops.maximum(a, ops.num(0.0)), b)
        if op == "==":
            return a == b
        if op == "!=":
            return a != b
        if op == "<":
            return a < b
        if op == ">":
            return a > b
        if op == "<=":
            return a <= b
        if op == ">=":
            return a >= b
        if op == "&&":
            return ops.logical_and(a, b)
        if op == "||":
            return ops.logical_or(a, b)
    if isinstance(expr, P.Call):
        ufn = env.get("__userfns__", {}).get(expr.name)
        if ufn is not None:
            # user `f(x, y) = expr` declaration: evaluate its body with the
            # parameters bound over the current env (free variables resolve
            # to model state, like the generated Rust local fn)
            params, body = ufn
            if len(params) != len(expr.args):
                raise TypeError(
                    f"DSL function {expr.name!r} takes {len(params)} args,"
                    f" got {len(expr.args)}")
            call_env = dict(env)
            for prm, arg in zip(params, expr.args):
                call_env[prm] = eval_expr(arg, env)
            return eval_expr(body, call_env)
        args = [eval_expr(a, env) for a in expr.args]
        out = ops.call(expr.name, args)
        if out is not None:
            return out
        # struct calls in expression position, e.g.
        # `receptors.get_receptor_currents(dt, c_m)` — resolved through the
        # env's function table (nb_macro/src/lib.rs struct-call codegen)
        efn = env.get("__fns__", {}).get(expr.name)
        if efn is None:
            raise NameError(f"unknown DSL function {expr.name!r}")
        return efn(env, args)
    raise TypeError(f"cannot evaluate {expr!r}")


def run_statements(stmts, env, mask=None, methods=None):
    """Execute a statement list on ``env`` (dict name -> value, with its
    backend under ``"__ops__"``).

    DiffEq deltas are accumulated and applied after the list (matching the
    codegen's deferred `self.X += dX`).  ``mask`` (a bool value or None)
    conditions every write — used for [if] branches, as a ``where``
    instead of control flow.  ``methods`` resolves struct calls
    (`l.update_current(v)`): dict path -> fn(env, arg_values) mutating env.
    """
    env = dict(env)
    ops = env["__ops__"]
    deltas = {}

    def write(name, value):
        if mask is not None and name in env:
            # where broadcasts in BOTH directions (a scalar-initialized
            # temp can be overwritten by an (N,) value inside an [if])
            env[name] = ops.where(mask, value, env[name])
        else:
            env[name] = value

    for stmt in stmts:
        if isinstance(stmt, P.FuncDef):
            fns = dict(env.get("__userfns__", {}))
            fns[stmt.name] = (stmt.params, stmt.expr)
            env["__userfns__"] = fns
        elif isinstance(stmt, P.Assign):
            write(stmt.target, eval_expr(stmt.expr, env))
        elif isinstance(stmt, P.DiffEq):
            delta = eval_expr(stmt.expr, env) * env["dt"]
            if mask is not None:
                delta = ops.where(mask, delta, 0.0)
            deltas[stmt.target] = deltas.get(stmt.target, 0.0) + delta
        elif isinstance(stmt, P.MethodCall):
            if methods is None or stmt.path not in methods:
                raise NameError(f"unknown struct call {stmt.path!r}")
            methods[stmt.path](env, [eval_expr(a, env) for a in stmt.args])
        elif isinstance(stmt, P.If):
            taken = None
            for cond_expr, body in zip(stmt.conditions, stmt.bodies):
                cond = eval_expr(cond_expr, env)
                branch = ops.cond(cond) if taken is None \
                    else ops.logical_and(cond, ops.logical_not(taken))
                branch_mask = branch if mask is None \
                    else ops.logical_and(branch, mask)
                sub_env, sub_deltas = run_statements(body, env, branch_mask,
                                                     methods)
                env.update(sub_env)
                for k, v in sub_deltas.items():
                    deltas[k] = deltas.get(k, 0.0) + v
                taken = branch if taken is None \
                    else ops.logical_or(taken, branch)
            if stmt.else_body:
                else_mask = ops.logical_not(taken)
                if mask is not None:
                    else_mask = ops.logical_and(else_mask, mask)
                sub_env, sub_deltas = run_statements(stmt.else_body, env,
                                                     else_mask, methods)
                env.update(sub_env)
                for k, v in sub_deltas.items():
                    deltas[k] = deltas.get(k, 0.0) + v
        else:
            raise TypeError(f"unknown statement {stmt!r}")
    return env, deltas


def _apply_deltas(env, deltas):
    for k, v in deltas.items():
        env[k] = env[k] + v
    return env


# ---------------------------------------------------------------------------
# Neuron compilation
# ---------------------------------------------------------------------------

NEURON_RESERVED = {"v", "i", "dt", "is_spiking", "last_firing_time"}


def build_neuron(block, registry):
    """Compile a [neuron] block into a NeuronModel subclass."""
    fields = dict(block.vars)
    # injected defaults (nb_macro/src/lib.rs:2149-2210); `v` stored as 'v'
    fields.setdefault("v", block.vars.get("current_voltage", 0.0))
    fields.pop("current_voltage", None)
    fields.setdefault("dt", 0.1)
    fields.setdefault("c_m", 1.0)
    fields.setdefault("gap_conductance", 10.0)

    on_iteration = block.sections.get("on_iteration", [])
    on_electrochemical = block.sections.get("on_electrochemical_iteration")
    on_spike = block.sections.get("on_spike", [])
    spike_detection = block.sections.get("spike_detection")
    if spike_detection is None:
        raise SyntaxError(f"[neuron] {block.type_name} needs spike_detection")
    # `spike_detection: continuous()` — HH/Morris-Lecar peak detection:
    # spike when above v_th, was increasing, and just stopped increasing.
    continuous = (isinstance(spike_detection, P.Call)
                  and spike_detection.name == "continuous"
                  and not spike_detection.args)
    if continuous:
        fields.setdefault("v_th", 30.0)

    kinetics_spec = block.sections.get("kinetics", "")
    nt_kind, rec_kind = "approximate", "approximate"
    if kinetics_spec:
        parts = [p.strip() for p in kinetics_spec.split(",")]
        if len(parts) >= 1 and parts[0]:
            nt_kind = registry.get(parts[0], parts[0])
        if len(parts) >= 2:
            rec_kind = registry.get(parts[1], parts[1])
    receptors_spec = block.sections.get("receptors", "")
    receptor_factory = registry.get(("receptors", receptors_spec)) \
        if receptors_spec else None

    # ion_channels: l = TestLeak, k = KChan (nb_macro lib.rs:2172-2196)
    channels = {}
    chan_spec = block.sections.get("ion_channels", "")
    if chan_spec:
        for part in chan_spec.split(","):
            alias, type_name = [x.strip() for x in part.split("=")]
            chan = registry.get(("ion_channel", type_name))
            if chan is None:
                raise NameError(f"unknown ion channel type {type_name!r}")
            channels[alias] = chan
            fields.update(chan.field_defaults(alias))

    class GeneratedNeuron(NeuronModel):
        name = block.type_name
        FIELDS = fields
        BOOL_FIELDS = dict(was_increasing=False) if continuous else {}
        # the parsed block: the mark of a generated neuron, from which
        # ops/dsl_kernels.py emits its kernel
        DSL_BLOCK = block

        def __init__(self, nt_kinetics=nt_kind, rec_kinetics=rec_kind,
                     receptors=None):
            if receptors is None and receptor_factory is not None:
                receptors = receptor_factory(rec_kinetics)
            super().__init__(nt_kinetics=nt_kinetics,
                             rec_kinetics=rec_kinetics, receptors=receptors)

        def _env(self, s, i, ops):
            env = {k: v for k, v in s.items()}
            env["i"] = i
            env["__ops__"] = ops
            # dotted views of ion-channel fields
            for alias, chan in channels.items():
                for dotted, key in chan.env_keys(alias):
                    env[dotted] = s[key]
            return env

        def _writeback(self, s, env):
            s.update({k: v for k, v in env.items() if k in s})
            for alias, chan in channels.items():
                for dotted, key in chan.env_keys(alias):
                    s[key] = env[dotted]
            return s

        def _methods(self, env):
            methods = {}
            for alias, chan in channels.items():
                def call(e, args, alias=alias, chan=chan):
                    v = args[0] if args else e["v"]
                    dt = args[1] if len(args) > 1 else e["dt"]
                    chan.update_current(e, alias, v, dt)
                methods[f"{alias}.update_current"] = call
            return methods

        def _run_electrochemical(self, s, i, t_input, t_valid, ops):
            env = self._env(s, i, ops)
            env["t"] = 0.0   # placeholder so `...(t, dt)` args evaluate
            methods = self._methods(env)

            def upd_kinetics(e, args):
                e.update(self.receptors.update_kinetics(e, t_input, t_valid))

            def set_currents(e, args):
                v = args[0] if args else e["v"]
                e.update(self.receptors.set_currents(e, v))

            def apply_t(e, args):
                if "nt$t" in e:
                    e["nt$t"] = K.apply_t_changes(
                        self.nt_kinetics, e, e["v"], e["is_spiking"])

            methods["receptors.update_receptor_kinetics"] = upd_kinetics
            methods["receptors.set_receptor_currents"] = set_currents
            methods["synaptic_neurotransmitters.apply_t_changes"] = apply_t
            env["__fns__"] = {
                "receptors.get_receptor_currents":
                    lambda e, args: self.receptors.receptor_dv(e),
            }
            env, deltas = run_statements(on_electrochemical, env,
                                         methods=methods)
            for k in ("i", "t", "__fns__"):
                env.pop(k, None)
            s = self._writeback(s, env)
            return _apply_deltas(s, deltas)

        def step(self, s, i, t_input=None, t_valid=None, skip_nt=False,
                 fns=TORCH_FNS):
            s = dict(s)
            ops = ops_for(s["v"], fns)
            last_voltage = s["v"]
            if t_input is not None and on_electrochemical is not None:
                # custom electrochemical body replaces the default template
                # (nb_macro neuron_receptor_integration.rs idiom: explicit
                # receptors.update_receptor_kinetics / set_receptor_currents /
                # get_receptor_currents / synaptic_neurotransmitters.
                # apply_t_changes calls inside the statement list)
                s = self._run_electrochemical(s, i, t_input, t_valid, ops)
            else:
                if t_input is not None:
                    s.update(self.receptors.update_kinetics(
                        s, t_input, t_valid))
                    s.update(self.receptors.set_currents(s, s["v"]))
                    rec_dv = self.receptors.receptor_dv(s)
                else:
                    rec_dv = 0.0

                env = self._env(s, i, ops)
                env, deltas = run_statements(on_iteration, env,
                                             methods=self._methods(env))
                env.pop("i", None)
                s = self._writeback(s, env)
                s = _apply_deltas(s, deltas)
                s["v"] = s["v"] - rec_dv

                if not skip_nt:
                    s["nt$t"] = K.apply_t_changes(
                        self.nt_kinetics, s, s["v"], s["is_spiking"])

            if continuous:
                s, spikes = self._handle_peak_detection(s, last_voltage)
            else:
                spikes = eval_expr(spike_detection, self._env(s, 0.0, ops))
            if on_spike:
                env = self._env(s, 0.0, ops)
                env, deltas2 = run_statements(on_spike, env, mask=spikes,
                                              methods=self._methods(env))
                env.pop("i", None)
                s = self._writeback(s, env)
                s = _apply_deltas(s, deltas2)
            s["is_spiking"] = spikes
            return s, spikes

    GeneratedNeuron.__name__ = block.type_name
    GeneratedNeuron.__qualname__ = block.type_name
    return GeneratedNeuron


def build_spike_train(block, registry):
    """Compile a [spike_train] block into a SpikeTrainModel subclass.

    Injected fields (nb_macro/src/lib.rs:4831-4850): current_voltage=0,
    v_th=30, v_resting=0, dt=0.1.  ``step(state, generator, clock)``
    returns ``(state, spikes)`` as the port's trains do.
    """
    fields = dict(block.vars)
    fields.setdefault("v_th", 30.0)
    fields.setdefault("v_resting", 0.0)
    on_iteration = block.sections.get("on_iteration", [])
    kinetics_spec = block.sections.get("kinetics", "").strip()
    nt_kind = registry.get(kinetics_spec, kinetics_spec) if kinetics_spec \
        else "approximate"

    class GeneratedSpikeTrain(SpikeTrainModel):
        name = block.type_name
        FIELDS = {k: v for k, v in fields.items()}

        def __init__(self, nt_kinetics=nt_kind, refractoriness="delta_dirac"):
            super().__init__(nt_kinetics=nt_kinetics,
                             refractoriness=refractoriness)

        def step(self, s, generator, clock):
            s = dict(s)
            env = dict(s)
            env["current_voltage"] = env.pop("v")
            env["__ops__"] = ops_for(env["current_voltage"])
            env, deltas = run_statements(on_iteration, env)
            env = _apply_deltas(env, deltas)
            env["v"] = env.pop("current_voltage")
            s.update({k: v for k, v in env.items() if k in s})
            s["is_spiking"] = torch.as_tensor(
                s["is_spiking"], device=s["v"].device).to(torch.bool) \
                .expand(s["v"].shape)
            spikes = s["is_spiking"]
            s["nt$t"] = K.apply_t_changes(self.nt_kinetics, s, s["v"], spikes)
            return s, spikes

    GeneratedSpikeTrain.__name__ = block.type_name
    GeneratedSpikeTrain.__qualname__ = block.type_name
    return GeneratedSpikeTrain


class IonChannelDef:
    """Compiled [ion_channel] block (nb_macro IonChannelDefinition,
    lib.rs:3959): per-channel vars (+ implicit `current` = 0), optional
    gating variables (BasicGatingVariable: alpha/beta/state with the Euler
    `update(dt)` rule, ion_channels/mod.rs:33-45), and an update_current
    body."""

    def __init__(self, block):
        self.type_name = block.type_name
        self.vars = dict(block.vars)
        self.vars.setdefault("current", 0.0)
        gating = block.sections.get("gating_vars", "")
        self.gating = [g.strip() for g in gating.split(",") if g.strip()]
        self.stmts = block.sections.get("on_iteration", [])
        self.uses_dt = "dt" in _names_in(self.stmts)

    def field_defaults(self, alias):
        out = {f"{alias}${v}": d for v, d in self.vars.items()}
        for g in self.gating:
            for attr in ("alpha", "beta", "state"):
                out[f"{alias}${g}${attr}"] = 0.0
        return out

    def env_keys(self, alias):
        """(dotted env name, state key) pairs for a channel instance."""
        pairs = [(f"{alias}.{v}", f"{alias}${v}") for v in self.vars]
        for g in self.gating:
            for attr in ("alpha", "beta", "state"):
                pairs.append((f"{alias}.{g}.{attr}", f"{alias}${g}${attr}"))
        return pairs

    def update_current(self, env, alias, v, dt):
        """Run the channel body in the neuron env (dotted keys)."""
        sub = {v_name: env[f"{alias}.{v_name}"] for v_name in self.vars}
        for g in self.gating:
            for attr in ("alpha", "beta", "state"):
                sub[f"{g}.{attr}"] = env[f"{alias}.{g}.{attr}"]
        sub["v"] = v
        sub["current_voltage"] = v
        sub["dt"] = dt
        sub["__ops__"] = env["__ops__"]

        methods = {}
        for g in self.gating:
            def gate_update(e, args, g=g):
                # BasicGatingVariable::update (ion_channels/mod.rs:40-44)
                d = args[0] if args else e["dt"]
                a, b, st = e[f"{g}.alpha"], e[f"{g}.beta"], e[f"{g}.state"]
                e[f"{g}.state"] = st + d * (a * (1.0 - st) - b * st)
            def gate_init(e, args, g=g):
                # BasicGatingVariable::init_state (ion_channels/mod.rs:35-37)
                a, b = e[f"{g}.alpha"], e[f"{g}.beta"]
                e[f"{g}.state"] = a / (a + b)
            methods[f"{g}.update"] = gate_update
            methods[f"{g}.init_state"] = gate_init

        sub, deltas = run_statements(self.stmts, sub, methods=methods)
        sub = _apply_deltas(sub, deltas)
        for v_name in self.vars:
            env[f"{alias}.{v_name}"] = sub[v_name]
        for g in self.gating:
            for attr in ("alpha", "beta", "state"):
                env[f"{alias}.{g}.{attr}"] = sub[f"{g}.{attr}"]


def _names_in(stmts):
    names = set()

    def walk_expr(e):
        if isinstance(e, P.Var):
            names.add(e.name)
        elif isinstance(e, P.Unary):
            walk_expr(e.operand)
        elif isinstance(e, P.BinOp):
            walk_expr(e.left)
            walk_expr(e.right)
        elif isinstance(e, P.Call):
            for a in e.args:
                walk_expr(a)

    def walk(sts):
        for st in sts:
            if isinstance(st, (P.Assign, P.DiffEq, P.FuncDef)):
                walk_expr(st.expr)
            elif isinstance(st, P.MethodCall):
                names.add(st.path.split(".")[-1])
                for a in st.args:
                    walk_expr(a)
            elif isinstance(st, P.If):
                for c in st.conditions:
                    walk_expr(c)
                for b in st.bodies:
                    walk(b)
                walk(st.else_body)

    walk(stmts)
    return names


def build_ion_channel(block, registry):
    chan = IonChannelDef(block)

    class GeneratedIonChannel:
        """Standalone channel usable like the generated Rust struct: its
        state (n,) float32 tensors on ``device``."""

        _def = chan

        def __init__(self, n=1, device="cpu", **overrides):
            self.n = n
            self.device = torch.device(device)
            self.state = {}
            for k, d in chan.field_defaults("ch").items():
                self.state[k.split("$", 1)[1]] = torch.full(
                    (n,), d, dtype=torch.float32, device=self.device)
            for k, v in overrides.items():
                key = k.replace(".", "$")
                self.state[key] = torch.full((n,), v, dtype=torch.float32,
                                             device=self.device)

        def __getattr__(self, name):
            state = object.__getattribute__(self, "state")
            key = name.replace(".", "$")
            if key in state:
                arr = state[key]
                return float(arr[0]) if arr.shape == (1,) else arr
            raise AttributeError(name)

        def __setattr__(self, name, value):
            if name in ("n", "state", "device"):
                object.__setattr__(self, name, value)
                return
            key = name.replace(".", "$")
            if key in self.state:
                self.state[key] = torch.as_tensor(
                    value, dtype=torch.float32, device=self.device
                ).expand(self.state[key].shape).clone()
            else:
                object.__setattr__(self, name, value)

        def set_gating(self, g, **attrs):
            for a, v in attrs.items():
                self.state[f"{g}${a}"] = torch.full(
                    (self.n,), v, dtype=torch.float32, device=self.device)

        def update_current(self, v, dt=0.1):
            env = {("ch." + k.replace("$", ".")): val
                   for k, val in self.state.items()}
            env["__ops__"] = TorchOps(TORCH_FNS, self.device)
            full = lambda x: torch.as_tensor(
                x, dtype=torch.float32, device=self.device).expand(
                    (self.n,)).clone()
            chan.update_current(env, "ch", full(v), full(dt))
            env.pop("__ops__")
            self.state = {k[len("ch."):].replace(".", "$"): val
                          for k, val in env.items()}
            return self.current

    GeneratedIonChannel.__name__ = block.type_name
    GeneratedIonChannel.__qualname__ = block.type_name
    return chan, GeneratedIonChannel


def build_nt_kinetics(block):
    """Compile a [neurotransmitter_kinetics] block: registers a new kind in
    the kinetics registry operating on (N, K) tensors."""
    on_iteration = block.sections["on_iteration"]
    params = {f"nt${k}": v for k, v in block.vars.items() if k != "t"}

    def update(t, v, spiking, dt, state_params):
        col = lambda x: x[:, None] if x.ndim == 1 else x
        env = {"t": t, "v": col(v), "current_voltage": col(v),
               "is_spiking": col(spiking), "dt": col(dt),
               "__ops__": TorchOps(TORCH_FNS, t.device)}
        for k in block.vars:
            if k != "t":
                env[k] = state_params[f"nt${k}"]
        env, deltas = run_statements(on_iteration, env)
        env = _apply_deltas(env, deltas)
        return env["t"]

    K.NT_KINETICS[block.type_name] = update
    K.NT_PARAM_DEFAULTS[block.type_name] = params
    return block.type_name


def build_receptor_kinetics(block):
    """Compile a [receptor_kinetics] block into the receptor-kinetics
    registry (operates on (N, K) gating tensors)."""
    on_iteration = block.sections["on_iteration"]
    params = {f"rec${k}": v for k, v in block.vars.items() if k != "r"}

    def update(r, t, dt, state_params):
        env = {"r": r, "t": t,
               "dt": dt[:, None] if dt.ndim == 1 else dt,
               "__ops__": TorchOps(TORCH_FNS, r.device)}
        for k in block.vars:
            if k != "r":
                env[k] = state_params[f"rec${k}"]
        env, deltas = run_statements(on_iteration, env)
        env = _apply_deltas(env, deltas)
        return env["r"]

    K.REC_KINETICS[block.type_name] = update
    K.REC_PARAM_DEFAULTS[block.type_name] = params
    return block.type_name


def build_refractoriness(block):
    """Compile a [neural_refractoriness] block (effect expression over
    timestep difference; spike_train/mod.rs:37-46 trait)."""
    effect_expr = block.sections["effect"]
    defaults = dict(block.vars)

    def effect(k, a, time_difference, v_resting, dt):
        # the grammar's effect scope exposes v_th/v_max alongside the
        # amplitude (caller passes a = v_th - v_resting,
        # spike_train/mod.rs:84-86 / delta_dirac_refractoriness.rs:9-12)
        ops = ops_for(k)
        env = {"decay": k, "k": k, "a": a, "time_difference": time_difference,
               "v_resting": v_resting, "dt": dt,
               "v_th": a + v_resting, "v_max": a + v_resting,
               "__ops__": ops}
        env.update({name: ops.num(v) for name, v in defaults.items()
                    if name not in env})
        return eval_expr(effect_expr, env)

    REFRACTORINESS[block.type_name] = effect
    return block.type_name


def build_receptors(block, registry):
    """Compile a [receptors] block into a ReceptorSystem subclass with
    per-neurotransmitter groups (lixirnet DopaGluGABA-style)."""
    type_names = tuple(g["neurotransmitter"] for g in block.groups)
    top_vars = dict(block.vars)
    default_kinetics = registry.get(block.sections.get("kinetics", ""),
                                    block.sections.get("kinetics", "approximate"))

    class GeneratedReceptors(ReceptorSystem):
        pass

    GeneratedReceptors.type_names = type_names
    GeneratedReceptors.__name__ = block.type_name
    GeneratedReceptors.__qualname__ = block.type_name

    groups = block.groups
    max_slots = max(len(g["receptors"]) if g["receptors"] else 1
                    for g in groups)

    def __init__(self, kinetics=default_kinetics or "approximate"):
        self.kinetics = kinetics

    def config_key(self):
        return (type(self), self.kinetics)

    def init_fields(self, n):
        # host-side NumPy construction: the model moves the state to the
        # device in one pass
        s = {"rec$mask": np.zeros((n, len(type_names)), bool),
             "rec$current": np.zeros((n, len(type_names)), np.float32)}
        for name, d in top_vars.items():
            s[f"rec${name}"] = np.full((n,), d, np.float32)
        for slot in range(max_slots):
            key = "rec$r" if slot == 0 else f"rec$r{slot + 1}"
            s[key] = np.zeros((n, len(type_names)), np.float32)
        for f, d in K.REC_PARAM_DEFAULTS[self.kinetics].items():
            s[f] = np.full((n, len(type_names)), d, np.float32)
        for g in groups:
            for name, d in g["vars"].items():
                s[f"rec${g['neurotransmitter']}${name}"] = \
                    np.full((n,), d, np.float32)
        return s

    def update_kinetics(self, state, t_input, t_valid):
        out = {}
        for slot in range(max_slots):
            key = "rec$r" if slot == 0 else f"rec$r{slot + 1}"
            sp = dict(state)
            sp["rec$r"] = state[key]
            out[key] = K.update_receptor_kinetics(
                self.kinetics, sp, t_input, t_valid)
        return out

    def set_currents(self, state, v):
        out = {}
        ops = ops_for(v)
        env = {"v": v, "current_voltage": v, "dt": state["dt"],
               "__ops__": ops}
        for name in top_vars:
            env[name] = state[f"rec${name}"]
        mask = state["rec$mask"]
        currents = []
        for gi, g in enumerate(groups):
            genv = dict(env)
            slot_names = g["receptors"] if g["receptors"] else ["r"]
            for slot, rname in enumerate(slot_names):
                key = "rec$r" if slot == 0 else f"rec$r{slot + 1}"
                genv[rname] = state[key][:, gi]
            if not g["receptors"]:
                genv["r"] = state["rec$r"][:, gi]
            for name in g["vars"]:
                genv[name] = state[f"rec${g['neurotransmitter']}${name}"]
            genv, deltas = run_statements(g["on_iteration"], genv)
            genv = _apply_deltas(genv, deltas)
            gmask = mask[:, gi]
            # write back group vars + shared top-level vars (masked)
            for name in g["vars"]:
                key = f"rec${g['neurotransmitter']}${name}"
                out[key] = ops.where(gmask, genv[name], state[key])
            for name in top_vars:
                prev = out.get(f"rec${name}", state[f"rec${name}"])
                out[f"rec${name}"] = ops.where(gmask, genv[name], prev)
                env[name] = out[f"rec${name}"]
            cur = genv.get("current")
            currents.append(ops.where(gmask, cur, 0.0)
                            if cur is not None else torch.zeros_like(v))
        out["rec$current"] = torch.stack(
            [torch.broadcast_to(c, v.shape) for c in currents], dim=-1)
        return out

    def receptor_dv(self, state):
        total = torch.sum(state["rec$current"], dim=-1)
        return total * (state["dt"] / state["c_m"])

    GeneratedReceptors.__init__ = __init__
    GeneratedReceptors.config_key = config_key
    GeneratedReceptors.init_fields = init_fields
    GeneratedReceptors.update_kinetics = update_kinetics
    GeneratedReceptors.set_currents = set_currents
    GeneratedReceptors.receptor_dv = receptor_dv
    return GeneratedReceptors


def neuron_builder(source):
    """Compile `.nb` source; returns a dict of generated classes / kinds
    (the equivalent of `neuron_builder!`, nb_macro/src/lib.rs:9303-9365)."""
    blocks = P.parse(source)
    # two definitions with one type name would be a Rust name collision in
    # the reference (nb_macro emits a struct per block); reject up front
    seen = set()
    for b in blocks:
        if b.type_name in seen:
            raise SyntaxError(f"duplicate definition: {b.type_name!r}")
        seen.add(b.type_name)
    out = {}
    registry = {}
    # kinetics first (neurons reference them by name)
    for b in blocks:
        if b.kind == "neurotransmitter_kinetics":
            kind = build_nt_kinetics(b)
            registry[b.type_name] = kind
            out[b.type_name] = kind
        elif b.kind == "receptor_kinetics":
            kind = build_receptor_kinetics(b)
            registry[b.type_name] = kind
            out[b.type_name] = kind
        elif b.kind == "neural_refractoriness":
            out[b.type_name] = build_refractoriness(b)
    for b in blocks:
        if b.kind == "ion_channel":
            chan, cls = build_ion_channel(b, registry)
            registry[("ion_channel", b.type_name)] = chan
            out[b.type_name] = cls
        elif b.kind == "receptors":
            cls = build_receptors(b, registry)
            registry[("receptors", b.type_name)] = cls
            out[b.type_name] = cls
    for b in blocks:
        if b.kind == "neuron":
            out[b.type_name] = build_neuron(b, registry)
        elif b.kind == "spike_train":
            out[b.type_name] = build_spike_train(b, registry)
    return out


def neuron_builder_from_file(path):
    """`neuron_builder_from_file!` equivalent."""
    with open(path) as f:
        return neuron_builder(f.read())

"""Kernel 4's DSL arm: a CUDA functor generated from each DSL neuron.

PyTorch/CUDA counterpart of the TPU kernel ``fused_model_multistep`` of
``spiking_neural_networks_tpu/ops/pallas_stencil.py`` for the neurons of
the DSL (``dsl/builder.py``), which the TPU kernel traces into its body.
Here the emitter runs the generated neuron's own ``step(s, i,
skip_nt=True)`` on symbolic values (`Sym`): the DSL interpreter takes its
operations from the values' backend (`EmitOps`), so each arithmetic
operation, comparison, select and function call of the step becomes one
line of C, in the order the twin (`model_kernels.model_steps_reference`,
the same step on tensors with `model_kernels.KERNEL_FNS`) computes it:
masks as selects, deltas as ``0.0f + d``, ion-channel bodies and user
functions inlined.  The result is one functor in the form of
``csrc/model_stencil.cu``'s and the model kernel's C entries for it
(`generated_source`), compiled by nvcc at first use (`load`,
``_build.load_generated``) and run through the kernel's two designs of
``csrc/model_stencil.cuh`` by `model_kernels.ModelRun`.

The analysis (`analyze`) also finds the layout: a field is carried unless
its final value is its own input (so ``prev_v = v`` carries ``prev_v``:
the freeze the JAX package's forwarding analysis once had), and read when
its input reaches an output.  A model is rejected (`reject_reason`) where
its step makes a value of another type than its field, or has more than
``MAX_FIELDS`` fields; it then runs on the plain route.  (The kernel itself reads v and
gap_conductance, so both are always read.)  A build or launch failure raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

MAX_FIELDS = 32           # MS_MAX_FIELDS
DSL_KIND = 64             # MS_DSL_KIND: the kind of a generated functor
# the C field codes (csrc/model_stencil.cuh)
F32, BOOL, I32, CARRIED, READ = 0, 1, 2, 4, 8

# the DSL's builtin functions on the kernel route: their C function (the
# twins are `model_kernels.KERNEL_FNS` and the exact torch functions)
C_FUNCTIONS = {"exp": "kernel_exp", "ln": "kernel_ln", "log": "kernel_ln",
               "log10": "kernel_log10", "tanh": "kernel_tanh",
               "sinh": "kernel_sinh", "cosh": "kernel_cosh",
               "sqrt": "sqrtf", "sin": "kernel_sin", "cos": "kernel_cos",
               "tan": "kernel_tan", "abs": "fabsf", "floor": "floorf",
               "ceil": "ceilf", "min": "ms_minimum", "max": "ms_maximum"}
# the functions that evaluate in float64 (csrc/model_stencil.cuh's
# ms_trig_parts): a step that calls one keeps at most TRIG_MAX_CPT cells a
# persistent thread (at 4 its 64 registers spilled on an H100)
TRIG_FUNCTIONS = ("kernel_sin", "kernel_cos", "kernel_tan")
TRIG_MAX_CPT = 2


class EmitError(ValueError):
    """The emitter does not take this model."""


class Sym:
    """A symbolic value of the emitted step: node ``i`` of graph ``g``, of
    type ``t`` ("f" float, "b" bool)."""

    __slots__ = ("g", "i", "t")

    def __init__(self, g, i, t):
        self.g, self.i, self.t = g, i, t

    @property
    def dsl_ops(self):
        return self.g.ops

    __hash__ = object.__hash__

    def __bool__(self):
        raise EmitError("the step branches on a value in Python")

    def _bin(self, op, other, reflected=False):
        a, b = (self.g.lift(other), self) if reflected \
            else (self, self.g.lift(other))
        return self.g.arith(op, a, b)

    def __add__(self, o): return self._bin("+", o)
    def __radd__(self, o): return self._bin("+", o, True)
    def __sub__(self, o): return self._bin("-", o)
    def __rsub__(self, o): return self._bin("-", o, True)
    def __mul__(self, o): return self._bin("*", o)
    def __rmul__(self, o): return self._bin("*", o, True)
    def __truediv__(self, o): return self._bin("/", o)
    def __rtruediv__(self, o): return self._bin("/", o, True)

    def __neg__(self):
        return self.g.node("neg", (self.g.to_f(self).i,), "f")

    def _cmp(self, op, other):
        return self.g.compare(op, self, self.g.lift(other))

    def __lt__(self, o): return self._cmp("<", o)
    def __le__(self, o): return self._cmp("<=", o)
    def __gt__(self, o): return self._cmp(">", o)
    def __ge__(self, o): return self._cmp(">=", o)
    def __eq__(self, o): return self._cmp("==", o)
    def __ne__(self, o): return self._cmp("!=", o)

    def __and__(self, o): return self.g.ops.logical_and(self, o)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        # the torch call of the port's shared step code
        # (`NeuronModel._handle_peak_detection`)
        if func is not torch.logical_not or kwargs:
            raise EmitError(f"the emitter has no form of {func}")
        return args[0].g.ops.logical_not(args[0])


def c_float(value):
    """The C literal of the float32 ``value``: 9 significant digits, which
    read back as the same float32."""
    v = np.float32(value)
    if np.isnan(v):
        return "__int_as_float(0x7fc00000)"
    if np.isinf(v):
        return ("-" if v < 0 else "") + "__int_as_float(0x7f800000)"
    s = "%.9g" % float(v)
    if not any(c in s for c in ".en"):
        s += ".0"
    return f"({s}f)" if s.startswith("-") else s + "f"


class Graph:
    """The step's operations in the order the interpreter makes them: node
    ``k`` is ``(op, args, type)``, args node indices or Python values."""

    def __init__(self):
        self.nodes = []
        self.ops = EmitOps(self)

    def node(self, op, args, t):
        self.nodes.append((op, args, t))
        return Sym(self, len(self.nodes) - 1, t)

    def lift(self, x):
        if isinstance(x, Sym):
            if x.g is not self:
                raise EmitError("a value of another step")
            return x
        if isinstance(x, (bool, np.bool_)):
            return self.node("bconst", (bool(x),), "b")
        if isinstance(x, (int, float, np.floating, np.integer)):
            return self.node("const", (float(np.float32(x)),), "f")
        raise EmitError(f"the emitter has no form of a {type(x).__name__}")

    def to_f(self, x):
        x = self.lift(x)
        return self.node("b2f", (x.i,), "f") if x.t == "b" else x

    def to_b(self, x):
        """``x`` as a condition: nonzero is true (``jnp.where``'s and
        `TorchOps.cond`'s reading of a float)."""
        x = self.lift(x)
        if x.t == "b":
            return x
        return self.node("!=", (x.i, self.lift(0.0).i), "b")

    def arith(self, op, a, b):
        return self.node(op, (self.to_f(a).i, self.to_f(b).i), "f")

    def compare(self, op, a, b):
        if a.t != b.t:
            a, b = self.to_f(a), self.to_f(b)
        return self.node(op, (a.i, b.i), "b")


class EmitOps:
    """The interpreter's operations on `Sym` values (the backend of
    `dsl.builder.eval_expr` / `run_statements` that `dsl.builder.TorchOps`
    is on tensors), for the kernel route (`model_kernels.KERNEL_FNS`)."""

    def __init__(self, g):
        self.g = g

    def num(self, value):
        return self.g.lift(float(np.float32(value)))

    def cond(self, c):
        return c if isinstance(c, bool) else self.g.to_b(c)

    def where(self, c, a, b):
        g = self.g
        if isinstance(c, bool):
            return a if c else b
        c, a, b = g.to_b(c), g.lift(a), g.lift(b)
        if a.t != b.t:
            a, b = g.to_f(a), g.to_f(b)
        return g.node("sel", (c.i, a.i, b.i), a.t)

    def logical_and(self, a, b):
        if isinstance(a, bool) and isinstance(b, bool):
            return a and b
        return self.g.node("&&", (self.g.to_b(a).i, self.g.to_b(b).i), "b")

    def logical_or(self, a, b):
        if isinstance(a, bool) and isinstance(b, bool):
            return a or b
        return self.g.node("||", (self.g.to_b(a).i, self.g.to_b(b).i), "b")

    def logical_not(self, a):
        if isinstance(a, bool):
            return not a
        return self.g.node("!", (self.g.to_b(a).i,), "b")

    def _call(self, fn, *args):
        return self.g.node("call", (fn,) + tuple(self.g.to_f(a).i
                                                 for a in args), "f")

    def pow(self, a, b):
        return self._call("ms_pow", a, b)

    def maximum(self, a, b):
        return self._call("ms_maximum", a, b)

    def call(self, name, args):
        if name == "heaviside":
            return self.g.to_f(self.g.to_f(args[0]) > 0.0)
        fn = C_FUNCTIONS.get(name)
        return None if fn is None else self._call(fn, *args)


class Layout(NamedTuple):
    """A generated neuron's kernel: ``fields`` its ((name, dtype), ...)
    planes in `model_kernels.model_kernel_fields` order, ``carry`` the
    fields its step writes, ``reads`` those it reads, ``codes`` the C field
    codes, ``functor`` the C text of its functor ``Dsl``, ``ops`` the
    operations of one step by kind (an operator, or a function's C name),
    for a bound."""
    fields: tuple
    carry: tuple
    reads: tuple
    codes: tuple
    functor: str
    ops: dict


def is_generated(model):
    """Whether ``model`` is a neuron of the DSL (``dsl.builder``)."""
    return getattr(type(model), "DSL_BLOCK", None) is not None


@functools.lru_cache(maxsize=None)
def _analysis(cls):
    try:
        return analyze(cls), None
    except EmitError as exc:
        return None, str(exc)


def layout(model):
    """The `Layout` of a generated neuron, or None where the emitter does
    not take it (`reject_reason`)."""
    return _analysis(type(model))[0]


def reject_reason(model):
    """Why the emitter does not take the generated neuron ``model`` (None
    where it does)."""
    return _analysis(type(model))[1]


def analyze(cls):
    """Run one step of the generated neuron class ``cls`` on symbolic
    values and return its `Layout`; raises `EmitError` where the emitter
    does not take it."""
    from .model_kernels import KERNEL_FNS, kernel_fields
    fields = kernel_fields(cls)
    if len(fields) > MAX_FIELDS:
        raise EmitError(f"{len(fields)} fields, more than {MAX_FIELDS}")
    if cls.INT_FIELDS:
        raise EmitError("int fields")
    g = Graph()
    s = {name: g.node("in", (k,), "b" if dt == torch.bool else "f")
         for k, (name, dt) in enumerate(fields)}
    i_syn = g.node("i_syn", (), "f")
    s2, spikes = cls().step(dict(s), i_syn, skip_nt=True, fns=KERNEL_FNS)
    spike = g.lift(spikes)
    if spike.t != "b":
        raise EmitError("the spike detection is not a condition")
    carry = tuple(name for name, _ in fields
                  if name == "is_spiking" or s2[name] is not s[name])
    outs = []
    for k, (name, dt) in enumerate(fields):
        if name == "is_spiking" or name not in carry:
            continue
        val = g.lift(s2[name])
        if val.t != ("b" if dt == torch.bool else "f"):
            raise EmitError(f"the step makes {name} another type")
        outs.append((k, name, val))
    # the nodes the outputs need, and the fields they read
    need = set()
    todo = [val.i for _, _, val in outs] + [spike.i]
    while todo:
        n = todo.pop()
        if n in need:
            continue
        need.add(n)
        op, args, _ = g.nodes[n]
        if op == "call":
            todo += args[1:]
        elif op not in ("in", "const", "bconst", "i_syn"):
            todo += args
    # the kernel itself reads v (the neighbours' gather) and
    # gap_conductance (the input current)
    read_idx = {g.nodes[n][1][0] for n in need if g.nodes[n][0] == "in"}
    reads = tuple(name for k, (name, _) in enumerate(fields)
                  if k in read_idx or name in ("v", "gap_conductance"))
    codes = tuple((BOOL if dt == torch.bool else F32)
                  + (CARRIED if name in carry else 0)
                  + (READ if name in reads else 0)
                  for name, dt in fields)
    ops = {}
    for n in need:
        op, args, _ = g.nodes[n]
        if op not in ("in", "const", "bconst", "i_syn"):
            key = args[0] if op == "call" else op
            ops[key] = ops.get(key, 0) + 1
    functor = _functor(cls, fields, codes, g, need, outs, spike,
                       any(f in ops for f in TRIG_FUNCTIONS))
    return Layout(fields, carry, reads, codes, functor, ops)


def max_cpt(model):
    """The most cells a persistent thread takes for the generated neuron
    ``model`` by its functions: `TRIG_MAX_CPT` where its step calls sin,
    cos or tan, else None (no cap of its own)."""
    lay = layout(model)
    if lay is not None and any(f in lay.ops for f in TRIG_FUNCTIONS):
        return TRIG_MAX_CPT
    return None


def _expr(g, op, args, t):
    x = lambda n: f"x{n}"
    if op == "in":
        return f"c.{'b' if t == 'b' else 'f'}({args[0]})"
    if op == "i_syn":
        return "i_syn"
    if op == "const":
        return c_float(args[0])
    if op == "bconst":
        return "true" if args[0] else "false"
    if op == "neg":
        return f"-{x(args[0])}"
    if op == "!":
        return f"!{x(args[0])}"
    if op == "b2f":
        return f"{x(args[0])} ? 1.0f : 0.0f"
    if op == "sel":
        return f"{x(args[0])} ? {x(args[1])} : {x(args[2])}"
    if op == "call":
        return f"{args[0]}({', '.join(x(a) for a in args[1:])})"
    return f"{x(args[0])} {op} {x(args[1])}"


def _functor(cls, fields, codes, g, need, outs, spike, trig):
    code_txt = []
    for c in codes:
        base = "BOOL" if c & BOOL else "F32"
        code_txt.append(" | ".join([base] + (["CARRIED"] if c & CARRIED
                                             else [])
                                   + (["READ"] if c & READ else [])))
    idx = {name: k for k, (name, _) in enumerate(fields)}
    # an anonymous namespace: each generated library's Dsl and the kernels
    # instantiated on it stay internal, so two loaded libraries never
    # resolve each other's symbols
    lines = [f"// the DSL neuron {cls.__name__}: fields in "
             f"model_kernel_fields order",
             "namespace {",
             "struct Dsl {",
             f"    enum {{ v = {idx['v']}, gap = {idx['gap_conductance']}, "
             f"is_spiking = {idx['is_spiking']}, n_fields = {len(fields)} "
             f"}};",
             "    static constexpr int codes[n_fields] = {"]
    if trig:
        lines[-1:-1] = [f"    // float64 sin / cos / tan: at most "
                        f"{TRIG_MAX_CPT} cells a persistent thread",
                        f"    static constexpr int max_cpt = {TRIG_MAX_CPT};"]
    for k, (name, _) in enumerate(fields):
        lines.append(f"        {code_txt[k]},{' ' * max(1, 30 - len(code_txt[k]))}"
                     f"// {k}: {name}")
    lines += ["    };",
              "    template <class Cell>",
              "    __device__ static bool step(const Cell& c, float i_syn)",
              "    {"]
    for n in sorted(need):
        op, args, t = g.nodes[n]
        ctype = "bool" if t == "b" else "float"
        note = f"  // {fields[args[0]][0]}" if op == "in" else ""
        lines.append(f"        const {ctype} x{n} = {_expr(g, op, args, t)};"
                     f"{note}")
    for k, name, val in outs:
        setter = "set_b" if val.t == "b" else "set"
        lines.append(f"        c.{setter}({k}, x{val.i});  // {name}")
    lines += [f"        return x{spike.i};", "    }", "};", "}  // namespace"]
    return "\n".join(lines)


ENTRIES = r'''
extern "C" {

int model_stencil_max_offsets() { return MS_MAX_OFFSETS; }

void model_stencil_limits(int* out) { ms_limits(out); }

int model_stencil_layout(int kind, int* codes)
{
    return kind == MS_DSL_KIND ? layout<Dsl>(codes) : -1;
}

int model_stencil_steps(int kind, MS_STEPS_PARAMS)
{
    return kind == MS_DSL_KIND ? ms_steps_entry<Dsl>(MS_STEPS_ARGS)
                               : (int)cudaErrorInvalidValue;
}

int model_stencil_persistent(int kind, MS_PERSISTENT_PARAMS)
{
    return kind == MS_DSL_KIND ? ms_persistent_entry<Dsl>(MS_PERSISTENT_ARGS)
                               : (int)cudaErrorInvalidValue;
}

}  // extern "C"
'''


def generated_source(model):
    """The CUDA source of the generated neuron ``model``'s kernel: its
    functor ``Dsl`` and the model kernel's C entries for kind
    `DSL_KIND`, over ``csrc/model_stencil.cuh``."""
    lay = layout(model)
    if lay is None:
        raise EmitError(f"no kernel for {type(model).__name__}: "
                        f"{reject_reason(model)}")
    return ("// Generated by spiking_neural_networks_tpu_torch/ops/"
            "dsl_kernels.py from a DSL neuron:\n"
            "// the model kernel (csrc/model_stencil.cuh) for one functor, "
            "whose step\n// repeats the twin's operations in order.\n\n"
            '#include "model_stencil.cuh"\n\n' + lay.functor + "\n"
            + ENTRIES)


def load(model):
    """The generated library of ``model``'s kernel, built by nvcc at first
    use (held per class, so a run's set-up neither hashes nor checks the
    files again)."""
    return _library(type(model))


@functools.lru_cache(maxsize=None)
def _library(cls):
    from .. import _build
    return _build.load_generated(generated_source(cls()))


def build(models):
    """Build the generated libraries of ``models`` in one round of nvcc
    runs started together; returns their paths."""
    from .. import _build
    return _build.build_generated([generated_source(m) for m in models])

"""Plasticity rules as vectorized edge updates.

PyTorch counterpart of ``spiking_neural_networks_tpu/core/plasticity.py``:
`STDP`, `BCM` and `RewardModulatedSTDP`.  An edge is updated once per
spiking endpoint, from the post-step state of both endpoints:

    dw_edge(i, j) = rule(i, j) * (spiking_i + spiking_j)

(BCM's two visits are serial: its delta reads the weight).  A runner
reads the rule's ``NODE_KEYS`` at both endpoints and applies
``apply_visits``.  Rule parameters are plain dicts; the runners hand the
updates 0-dim f32 tensors (`rule_tensors`), so each operation rounds as
the JAX package's f32 scalars do, with R-STDP's two decays hoisted out of
the step.  The float-op transcendental functions of the CUDA kernels
(`kernel_exp`, `kernel_log`, `kernel_pow`, `kernel_tanh`, `kernel_cosh`,
and the DSL's `kernel_ln`, `kernel_log10`, `kernel_sinh`, `kernel_sqrt`,
`kernel_pow_nan`, `kernel_sin`, `kernel_cos`, `kernel_tan`) live here too.
"""

from __future__ import annotations

import functools

import torch

from ..models.base import NEVER

@functools.lru_cache(maxsize=64)
def _rule_floats(items):
    r = {k: torch.tensor(v, dtype=torch.float32) for k, v in items}
    if "tau_c" in r:
        r["exp_dc"] = torch.exp(-r["dt"] / r["tau_c"])
    if "tau_d" in r:
        r["exp_dd"] = torch.exp(-r["dt"] / r["tau_d"])
    return {k: float(t) for k, t in r.items()}


def rule_floats(params):
    """The rule's parameters rounded to float32, as Python floats, with
    R-STDP's decays ``exp_dc = exp(-dt / tau_c)`` and ``exp_dd =
    exp(-dt / tau_d)`` hoisted as the TPU kernel hoists them.  The exps are
    taken once per parameter set on the host, so every device and route
    (kernel, twin, plain) decays traces and dopamine by the same numbers."""
    return dict(_rule_floats(tuple(sorted((k, float(v))
                                          for k, v in params.items()))))


def rule_tensors(params, device):
    """`rule_floats` as 0-dim float32 tensors on ``device``."""
    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in rule_floats(params).items()}


# kernel_exp: a Cephes-style float32 exp (range reduction by ln 2 in two
# parts, a degree-5 polynomial, exact power-of-two scaling)
_LOG2E = 1.44269504088896341
_LN2_HI, _LN2_LO = 0.693359375, -2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_EXP_MAX, _EXP_MIN = 88.72283905206835, -103.27892990343185


def _pow2(n):
    """2^n as float32 for int32 n in [-126, 127], built from its bits."""
    return ((n + 127) << 23).view(torch.float32)


def kernel_exp(x):
    """exp of a float32 tensor by the sequence of float32 operations the
    CUDA kernels use (``kernel_exp`` in ``csrc/plasticity_common.cuh``),
    within about an ulp of exp.  Each operation is a correctly rounded
    IEEE one, so the result is the same bits on every device: the kernels'
    twins take it where the kernels take it, and a kernel route on the
    card then equals the same route on the CPU.  Inputs are finite."""
    z = torch.floor(x * _LOG2E + 0.5)
    r = x - z * _LN2_HI
    r = r - z * _LN2_LO
    y = r * _EXP_POLY[0] + _EXP_POLY[1]
    for c in _EXP_POLY[2:]:
        y = y * r + c
    y = y * (r * r) + r + 1.0
    # z out of range only where x is, and that y is overwritten below
    n = torch.clamp(z, -150.0, 129.0).to(torch.int32)
    half = torch.div(n, 2, rounding_mode="trunc")
    y = y * _pow2(n - half) * _pow2(half)
    y = torch.where(x > _EXP_MAX, float("inf"), y)
    return torch.where(x < _EXP_MIN, 0.0, y)


# kernel_log: a Cephes-style float32 log (the mantissa in [sqrt(1/2),
# sqrt(2)) from the bits, a degree-9 polynomial, ln 2 in two parts)
_LOG_POLY = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
             -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
             2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_FLT_MIN = 1.17549435e-38


def kernel_log(x):
    """log of a positive finite float32 tensor by the float32 operations
    of ``kernel_log`` in ``csrc/chem_common.cuh``, within about an ulp:
    the same bits on every device, as `kernel_exp`."""
    tiny = x < _FLT_MIN
    x = torch.where(tiny, x * 8388608.0, x)          # 2^23: exact
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0xff) - 126 - torch.where(tiny, 23, 0).to(
        torch.int32)
    m = ((bits & 0x007fffff) | 0x3f000000).view(torch.float32)  # [0.5, 1)
    low = m < 0.70710678118654752
    e = e - low.to(torch.int32)
    m = torch.where(low, m + m - 1.0, m - 1.0)
    z = m * m
    y = m * _LOG_POLY[0] + _LOG_POLY[1]
    for c in _LOG_POLY[2:]:
        y = y * m + c
    y = y * m * z
    fe = e.to(torch.float32)
    y = y + fe * _LN2_LO
    y = y + -0.5 * z
    return m + y + fe * _LN2_HI


def kernel_pow(x, y):
    """``x ** y`` of float32 tensors as ``kernel_exp(y * kernel_log(|x|))``,
    with pow's exact cases: ``y == 1 -> x``, ``y == 0 -> 1``, ``x == 0 ->
    0`` for y > 0 and inf for y < 0, and for x < 0 the sign of an odd
    integer y or NaN for a y that is not an integer.  Float operations
    only, as `kernel_exp`; x and y are finite."""
    ax = torch.abs(x)
    p = kernel_exp(y * kernel_log(torch.where(ax > 0.0, ax, 1.0)))
    whole = torch.floor(y) == y
    odd = torch.floor(y * 0.5) * 2.0 != y
    p = torch.where(x < 0.0, torch.where(whole, torch.where(odd, -p, p),
                                         float("nan")), p)
    p = torch.where(x == 0.0, torch.where(y > 0.0, 0.0, float("inf")), p)
    p = torch.where(y == 0.0, 1.0, p)
    return torch.where(y == 1.0, x, p)


def kernel_pow_nan(x, y):
    """`kernel_pow` with a NaN where an operand is NaN (``x + y`` there,
    torch.pow's rule; `kernel_pow` takes finite operands and turns a NaN x
    into a number): the DSL's ``^`` on the kernel route (``ms_pow`` in
    ``csrc/model_stencil.cuh``), whose operands a rate at its 0/0 point
    can make NaN."""
    return torch.where(torch.isnan(x) | torch.isnan(y), x + y,
                       kernel_pow(x, y))


def kernel_tanh(x):
    """tanh of a float32 tensor as ``sign(x) (1 - 2 / (kernel_exp(2|x|) +
    1))``, by the float32 operations of ``kernel_tanh`` in
    ``csrc/model_stencil.cuh``: the same bits on every device, within 2e-7
    of tanh.  ``2 / y`` is ``reciprocal(y) * 2``, which rounds as the
    division does (the scaling by 2 is exact)."""
    e = kernel_exp(2.0 * torch.abs(x))
    t = 1.0 - 2.0 / (e + 1.0)
    return torch.where(x < 0.0, -t, t)


def kernel_cosh(x):
    """cosh of a float32 tensor as ``(e + 1 / e) / 2`` with ``e =
    kernel_exp(|x|)``, by the float32 operations of ``kernel_cosh`` in
    ``csrc/model_stencil.cuh``: the same bits on every device, within 4
    ulps of cosh where it is finite."""
    e = kernel_exp(torch.abs(x))
    return 0.5 * (e + 1.0 / e)


# sinh's Taylor coefficients 1/3!, 1/5!, 1/7!, 1/9! as float32 values
_SINH_POLY = (2.75573188e-06, 0.000198412701, 0.00833333377, 0.166666672)
_INV_LN10 = 0.434294492


def kernel_ln(x):
    """log of a float32 tensor by the float32 operations of ``kernel_ln``
    in ``csrc/model_stencil.cuh``: `kernel_log` where x is positive and
    finite, inf at inf, -inf at 0 and NaN below 0 or at NaN (the kernel
    route's ``ln`` / ``log`` of the DSL)."""
    pos = x > 0.0
    y = kernel_log(torch.where(pos, x, 1.0))
    y = torch.where(x == float("inf"), float("inf"), y)
    return torch.where(pos, y, torch.where(x == 0.0, float("-inf"),
                                           float("nan")))


def kernel_sqrt(x):
    """sqrt of a float32 tensor, correctly rounded on every device (the
    CUDA kernels' ``sqrtf``): torch's float32 sqrt on a CPU can be off by
    an ulp, so it is taken in float64 (correctly rounded there) and
    rounded once to float32, which for sqrt gives the correctly rounded
    float32 result."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def kernel_log10(x):
    """log10 of a float32 tensor as ``kernel_ln(x) * float32(1 / ln 10)``
    (``kernel_log10`` in ``csrc/model_stencil.cuh``): within 2 ulps of
    log10, the same bits on every device."""
    return kernel_ln(x) * _INV_LN10


def kernel_sinh(x):
    """sinh of a float32 tensor by the float32 operations of
    ``kernel_sinh`` in ``csrc/model_stencil.cuh``: below |x| = 1 the
    Taylor series to x^9 (no cancellation near 0), else ``sign(x) (e -
    1 / e) / 2`` with ``e = kernel_exp(|x|)``; within 2 ulps of sinh, the
    same bits on every device."""
    x2 = x * x
    p = x2 * _SINH_POLY[0] + _SINH_POLY[1]
    for c in _SINH_POLY[2:]:
        p = p * x2 + c
    small = x + x * (x2 * p)
    e = kernel_exp(torch.abs(x))
    big = 0.5 * (e - 1.0 / e)
    big = torch.where(x < 0.0, -big, big)
    return torch.where(torch.abs(x) < 1.0, small, big)


# sin, cos and tan in float64: a Cody-Waite reduction by pi/2 in three
# parts (P1 of 27 and P2 of 25 significant bits, so q * P1 and q * P2 are
# exact for |q| < 2^25), then fdlibm's minimax polynomials of sin and cos
# on [-pi/4, pi/4] (__kernel_sin / __kernel_cos), rounded once to float32
_TWO_OVER_PI = 0.6366197723675814
_PIO2_1, _PIO2_2, _PIO2_3 = (1.570796325802803, 9.920935739593517e-10,
                             5.721188726109832e-18)
_SIN_POLY = (1.58969099521155010221e-10, -2.50507602534068634195e-08,
             2.75573137070700676789e-06, -1.98412698298579493134e-04,
             8.33333333332248946124e-03, -1.66666666666666324348e-01)
_COS_POLY = (-1.13596475577881948265e-11, 2.08757232129817482790e-09,
             -2.75573143513906633035e-07, 2.48015872894767294178e-05,
             -1.38888888888741095749e-03, 4.16666666666666019037e-02)
# |x| below which the reduction is exact to the double's rounding:
# |q| < 2^25
TRIG_EXACT_MAX = 5.0e7


def _trig_parts(x):
    """``(n, s, c)`` of a float32 tensor: its quadrant n = q mod 4 and
    the float64 sin and cos of its remainder r = x - q pi/2 (|r| <= pi/4,
    clamped to [-1, 1] where the reduction has lost r: |x| past
    `TRIG_EXACT_MAX`).  The float64 operations of ``ms_trig_parts`` in
    ``csrc/model_stencil.cuh``, in order."""
    d = x.to(torch.float64)
    q = torch.round(d * _TWO_OVER_PI)
    r = d - q * _PIO2_1
    r = r - q * _PIO2_2
    r = r - q * _PIO2_3
    r = torch.where(q == 0.0, d, torch.clamp(r, -1.0, 1.0))
    n = q - 4.0 * torch.floor(q * 0.25)
    z = r * r
    p = z * _SIN_POLY[0] + _SIN_POLY[1]
    for k in _SIN_POLY[2:]:
        p = p * z + k
    s = r + (r * z) * p
    p = z * _COS_POLY[0] + _COS_POLY[1]
    for k in _COS_POLY[2:]:
        p = p * z + k
    c = (1.0 - 0.5 * z) + (z * z) * p
    return n, s, c


def kernel_sin(x):
    """sin of a float32 tensor by the float64 operations of ``kernel_sin``
    in ``csrc/model_stencil.cuh`` (`_trig_parts`), rounded once: within
    1 ulp of sin for |x| <= `TRIG_EXACT_MAX` (5e7), the same bits on
    every device.  Past that the reduction loses r: the error is at most
    about |x| 2^-52 and the result stays in [-1, 1] (finite).  NaN and
    +-inf give NaN."""
    n, s, c = _trig_parts(x)
    y = torch.where(n == 0.0, s, torch.where(
        n == 1.0, c, torch.where(n == 2.0, -s, -c)))
    return y.to(torch.float32)


def kernel_cos(x):
    """cos of a float32 tensor as `kernel_sin` computes sin
    (``kernel_cos`` in ``csrc/model_stencil.cuh``), with its accuracy."""
    n, s, c = _trig_parts(x)
    y = torch.where(n == 0.0, c, torch.where(
        n == 1.0, -s, torch.where(n == 2.0, -c, s)))
    return y.to(torch.float32)


def kernel_tan(x):
    """tan of a float32 tensor as ``s / c`` (even quadrant) or ``-c / s``
    (odd) of `_trig_parts`, divided in float64 and rounded once
    (``kernel_tan`` in ``csrc/model_stencil.cuh``): within 1 ulp of tan
    for |x| <= `TRIG_EXACT_MAX`, finite past it, NaN at NaN and +-inf."""
    n, s, c = _trig_parts(x)
    odd = (n == 1.0) | (n == 3.0)
    y = torch.where(odd, -c / s, s / c)
    return y.to(torch.float32)


def stdp_delta(t_pre, t_post, p, exp=torch.exp):
    """The STDP delta of one visit from int32 last firing times, 0 unless
    both endpoints have fired.  One exp of the selected argument, as the
    JAX package computes it; the kernels' twins pass ``kernel_exp``."""
    both = torch.logical_and(t_pre != NEVER, t_post != NEVER)
    diff = torch.abs((t_pre - t_post).to(torch.float32)) * p["dt"]
    pre_first = t_pre < t_post
    e = exp(torch.where(pre_first, -diff / p["tau_plus"],
                        -diff / p["tau_minus"]))
    dw = torch.where(pre_first, p["a_plus"] * e,
                     torch.where(t_pre > t_post, -p["a_minus"] * e, 0.0))
    return torch.where(both, dw, 0.0)


def rstdp_visit(w, c, dw, counter, delta, dopamine, p):
    """One visit of the R-STDP weight update; ``p`` from `rule_tensors`,
    with ``exp_dc = exp(-dt / tau_c)`` hoisted."""
    dw = dw + delta
    apply_trace = counter != 0
    c = torch.where(apply_trace, c * p["exp_dc"] + p["tau_c"] * dw, c)
    dw = torch.where(apply_trace, 0.0, dw)
    counter = torch.where(apply_trace, 0, 1).to(counter.dtype)
    w = w + c * dopamine
    return w, c, dw, counter


class STDP:
    """Pair-based spike-time-dependent plasticity.

    t_pre < t_post:  dw = +a_plus  * exp(-|t_pre - t_post| * dt / tau_plus)
    t_pre > t_post:  dw = -a_minus * exp(-|t_post - t_pre| * dt / tau_minus)
    """

    name = "stdp"
    # the node fields an edge update reads at both endpoints
    NODE_KEYS = ("last_firing_time", "is_spiking")

    def __init__(self, a_plus=2.0, a_minus=2.0, tau_plus=4.5, tau_minus=4.5,
                 dt=0.1):
        self.params = dict(a_plus=a_plus, a_minus=a_minus, tau_plus=tau_plus,
                           tau_minus=tau_minus, dt=dt)

    def set_dt(self, dt):
        self.params["dt"] = dt

    @staticmethod
    def edge_delta(w, pre, post, p):
        """The delta of one visit, without the per-spiking-endpoint count."""
        return stdp_delta(pre["last_firing_time"], post["last_firing_time"], p)

    @staticmethod
    def edge_dw(w, pre, post, p):
        count = pre["is_spiking"].to(torch.float32) \
            + post["is_spiking"].to(torch.float32)
        return STDP.edge_delta(w, pre, post, p) * count

    @staticmethod
    def apply_visits(w, pre, post, p, count):
        """``count`` serial visits; the delta does not read the weight, so
        they sum exactly."""
        return w + STDP.edge_delta(w, pre, post, p) * count

    def apply(self, graph, state, params):
        vals = {k: state[k] for k in ("last_firing_time", "is_spiking")}
        return graph.apply_edge_update(
            lambda w, pre, post: self.edge_dw(w, pre, post, params),
            vals, vals)


class BCM:
    """Bienenstock-Cooper-Munro rule.

    dw = (act_post (act_post - avg_post / average_scalar) act_pre
          - decay w) * dt

    from the endpoints' ``current_activity`` and ``average_activity``
    (the BCM neurons' and trains' bookkeeping), once per spiking endpoint.
    """

    name = "bcm"
    NODE_KEYS = ("current_activity", "average_activity", "is_spiking")

    def __init__(self, decay=0.1, average_scalar=0.1, dt=0.1):
        self.params = dict(decay=decay, average_scalar=average_scalar, dt=dt)

    def set_dt(self, dt):
        self.params["dt"] = dt

    @staticmethod
    def edge_delta(w, pre, post, p):
        """The delta of one visit, which reads the weight."""
        threshold = post["average_activity"] / p["average_scalar"]
        act = post["current_activity"]
        term = act * (act - threshold) * pre["current_activity"]
        return (term - p["decay"] * w) * p["dt"]

    @staticmethod
    def apply_visits(w, pre, post, p, count):
        """``count`` serial visits: the second visit (both endpoints
        spiking) decays the once-updated weight, so two visits are ``d1 +
        d2(w + d1)``, not ``2 d1``."""
        d1 = BCM.edge_delta(w, pre, post, p)
        d2 = BCM.edge_delta(w + d1, pre, post, p)
        return w + torch.where(count >= 2.0, d1 + d2, d1 * count)

    @staticmethod
    def edge_dw(w, pre, post, p):
        count = pre["is_spiking"].to(torch.float32) \
            + post["is_spiking"].to(torch.float32)
        return BCM.apply_visits(w, pre, post, p, count) - w

    def apply(self, graph, state, params):
        vals = {k: state[k] for k in self.NODE_KEYS}
        return graph.apply_edge_update(
            lambda w, pre, post: self.edge_dw(w, pre, post, params),
            vals, vals)


class RewardModulatedSTDP:
    """R-STDP with dopamine-modulated eligibility traces.

    Per-edge trace state: ``dw`` accumulator, trace ``c``, alternation
    ``counter``.  Every visit:

        dw   += stdp_delta
        every 2nd visit: c = c * exp(-dt / tau_c) + tau_c * dw ; dw = 0
        weight += c * dopamine

    The scalar dopamine decays as
    ``dopamine = dopamine * exp(-dt / tau_d) + tau_d * reward``.  The
    visit itself is `rstdp_visit`, its delta `stdp_delta`.
    """

    name = "rstdp"

    def __init__(self, tau_d=20.0, tau_c=0.0001, a_plus=2.0, a_minus=2.0,
                 tau_plus=4.5, tau_minus=4.5, dt=0.1):
        self.params = dict(tau_d=tau_d, tau_c=tau_c, a_plus=a_plus,
                           a_minus=a_minus, tau_plus=tau_plus,
                           tau_minus=tau_minus, dt=dt)
        self.dopamine = 0.0

    def set_dt(self, dt):
        self.params["dt"] = dt

    @staticmethod
    def update_dopamine(dopamine, reward, p):
        """``p`` from `rule_tensors` (``exp_dd`` hoisted)."""
        return dopamine * p["exp_dd"] + p["tau_d"] * reward

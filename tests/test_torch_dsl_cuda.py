"""Kernel 4's DSL arm on a card (``cuda`` marker; skips without one): the
kernel generated from each DSL neuron, in each design, against its twin
on the card, chained calls of 1, 2, 16 and 17 steps on one `ModelRun`
from a random state, bit for bit, with the launches the C entry counted.
No JAX here: the file runs on the machine with the card.

    python -m pytest -m cuda tests/test_torch_dsl_cuda.py
"""

import numpy as np
import pytest
import torch

import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu_torch.ops import model_kernels as mk

IZHIKEVICH_NB = """
[neuron]
    type: CudaIzhikevich
    vars: w = 30, a = 0.02, b = 0.2, c = -55, d = 8, v_th = 30, tau_m = 1, c_m = 100
    on_spike:
        v = c
        w += d
    spike_detection: v >= v_th
    on_iteration:
        dw/dt = (a * (b * v - w)) / tau_m
        dv/dt = (0.04 * v * v + 5 * v + 140 - w + i) / c_m
[end]
"""

FUNCS_NB = """
[neuron]
    type: CudaFuncs
    vars: w = 1, a = 0.5, v_th = 30, c = -60, flag = 0
    on_spike:
        v = c
    spike_detection: v >= v_th
    on_iteration:
        x = abs(v) + 1
        [if] v < -50 [then]
            flag = 1
        [elseif] v > 0 [then]
            flag = 2
        [else]
            flag = 0
        [end]
        w = sqrt(x) + ln(x) + log10(x) + sinh(w * 0.001) + cosh(a) + tanh(v * 0.01)
        dv/dt = floor(w) - ceil(a) + heaviside(v + 40) + min(v, 0) * max(a, 0.25) + ((x * 0.01) ^ 1.5) + ((v * 0.01) r^ 2) + exp(-x * 0.1) + i
[end]
"""

HH_NB = """
[ion_channel]
    type: CudaNa
    vars: e = 50, g = 120
    gating_vars: m, h
    on_iteration:
        m.alpha = 0.1 * ((v + 40.) / (1. - exp(-(v + 40.) / 10.)))
        m.beta = 4. * exp(-(v + 65.) / 18.)
        h.alpha = 0.07 * exp(-(v + 65.) / 20.)
        h.beta = 1. / (exp(-(v + 35.) / 10.) + 1.)
        m.update(dt)
        h.update(dt)
        current = m.state ^ 3 * h.state * g * (v - e)
[end]

[neuron]
    type: CudaHH
    ion_channels: na = CudaNa
    vars: v_th = 0, c_m = 1, dt = 0.01, g_l = 0.3, e_l = -55
    spike_detection: continuous()
    on_iteration:
        na.update_current(v)
        dv/dt = (i - na.current - g_l * (v - e_l)) / c_m
[end]
"""

# sin, cos and tan (kernel_sin, kernel_cos, kernel_tan): tan of the input
# current and a sin / cos drive in dv/dt
TRIG_NB = """
[neuron]
    type: CudaTrig
    vars: w = 30, a = 0.02, b = 0.2, c = -55, d = 8, v_th = 30, tau_m = 1, c_m = 100, drive = 0
    on_spike:
        v = c
        w += d
    spike_detection: v >= v_th
    on_iteration:
        drive = tan(i * 0.001)
        dw/dt = (a * (b * v - w)) / tau_m
        dv/dt = (0.04 * v * v + 5 * v + 140 - w + i + 4 * sin(v * 0.2) * cos(w * 0.1) + drive) / c_m
[end]
"""

SOURCES = {"CudaIzhikevich": IZHIKEVICH_NB, "CudaFuncs": FUNCS_NB,
           "CudaHH": HH_NB, "CudaTrig": TRIG_NB}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SOURCES))
@pytest.mark.parametrize("per_step", [False, True])
def test_generated_kernel_matches_twin(card, name, per_step):
    model = snt.dsl.neuron_builder(SOURCES[name])[name]()
    rows, cols = 33, 70
    rng = np.random.default_rng(5)
    g = snt.StencilGraph.build(rows, cols, snt.radius_offsets(2.0),
                               keep_prob=0.8, seed=3, device="cuda")
    fields, carry = mk.model_kernel_fields(model)
    st = model.init_state_host(rows * cols)
    planes = {k: torch.from_numpy(st[k].reshape(rows, cols)).cuda()
              for k, _ in fields}
    planes["v"] = torch.as_tensor(rng.uniform(-65, 30, (rows, cols)),
                                  dtype=torch.float32, device="cuda")
    lft = torch.full((rows, cols), -1, dtype=torch.int32, device="cuda")
    run = mk.ModelRun(model, planes, lft, g.weights, g.in_deg, g.offsets,
                      per_step=per_step)
    tp, tl, clock = dict(planes), lft, 0
    for k in (1, 2, 16, 17):
        before = mk.STEP_LAUNCHES
        got = run.steps(clock, k)
        want = mk.model_steps_reference(model, tp, tl, g.weights, g.in_deg,
                                        g.offsets, clock, k)
        torch.cuda.synchronize()
        assert mk.STEP_LAUNCHES - before == mk.call_launches(
            k, run.plan is not None)
        for key in carry:
            a, b = got[0][key], want[0][key]
            same = torch.equal(a.view(torch.int32), b.view(torch.int32)) \
                if a.dtype == torch.float32 else torch.equal(a, b)
            assert same, (key, k)
        assert torch.equal(got[1], want[1])
        tp = dict(tp, **{key: x.clone() for key, x in want[0].items()})
        tl, clock = want[1], clock + k

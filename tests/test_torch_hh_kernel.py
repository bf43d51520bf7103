"""The HH chemical kernel's plain twin against the TPU kernel it replaces,
`pallas_hh.fused_hh_multistep` (run in interpret mode on the CPU), the
port's `Lattice` on the HH route against the JAX `Lattice` on its Pallas
route, the wrapper's CPU route, checks and gate, and, on a CUDA card only,
the CUDA kernel against the twin.

Tolerance: rtol and atol 1e-5 with lft, spikes and was_increasing equal.
The twin and the TPU kernel compute the same association and differ in the
last ulp of exp (`kernel_exp` against XLA's).  Two places amplify that ulp
beyond 1e-5, and only they get a wider band:
- the Na and K currents of one call (rtol 1e-4): ``m * (m * m) * h`` and
  ``(n * n) * (n * n)`` multiply a gate's relative error 3 and 4 times
  over, and a 16-step call from a random state puts it at up to 1.6e-5;
- the 37 + 19-step run (5e-3, the band the JAX package's own test grants
  its kernel on the same run): at step 56 some neurons are mid-upstroke,
  where dv/dt is thousands of mV per ms and an ulp of a gate moves v by
  up to 2e-4 mV; firing times and was_increasing stay equal.
The card's kernel and the twin compute the same bits.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu.ops import graph as jg
from spiking_neural_networks_tpu.ops import pallas_hh
from spiking_neural_networks_tpu_torch.convert import lattice_from
from spiking_neural_networks_tpu_torch.ops import hh_kernels as hk
from torch_lattices import (assert_hh_match, bits_equal, hh_schedule_inputs,
                            jax_hh_lattice)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5
CURRENT_RTOL = 1e-4       # the Na and K currents of one call (see above)
RULE = dict(a_plus=2.0, a_minus=2.0, tau_plus=4.5, tau_minus=4.5, dt=0.1)
BASE = {"dt": 0.01, "c_m": 1.0, "v_th": 0.0, "gap_conductance": 10.0,
        "na$g": 120.0, "na$e": 50.0, "k$g": 36.0, "k$e": -77.0,
        "kleak$g": 0.3, "kleak$e": -55.0}
TYPED = {"nt$t_max": 1.0, "nt$v_p": 2.0, "nt$k_p": 5.0,
         "nt$clearance_constant": 0.01, "rec$alpha": 1.0, "rec$beta": 1.0,
         "rec$g": (1.0, 0.6, 1.2), "rec$e": (0.0, 0.0, -80.0), "rec$mg": 0.3}


def make_inputs(rows, cols, seed, nt, rec, nonuniform=True):
    """NumPy inputs of one kernel call: a state dict in the state's layout
    ((N,) and (N, 3)) and a JAX `StencilGraph` with random weights.  The
    state is random across the whole HH range (v in [-70, 40), gates in
    [0, 1), random flags and past firing times), so that neurons peak,
    fire and move weights within a few steps; with ``nonuniform``, every
    parameter varies by up to 10% per neuron and some receptor and
    neurotransmitter slots are missing."""
    rng = np.random.default_rng(seed)
    n = rows * cols
    g = jg.StencilGraph.build(rows, cols, jg.radius_offsets(2.0),
                              keep_prob=0.8, seed=seed + 1,
                              weight_fn=lambda dr, dc, rr, cc:
                              rng.uniform(0.5, 1.5, rr.shape))

    def f(lo, hi, shp=(n,)):
        return rng.uniform(lo, hi, shp).astype(np.float32)

    scale = (lambda shp: f(0.9, 1.1, shp)) if nonuniform \
        else (lambda shp: np.ones(shp, np.float32))
    st = {"v": f(-70, 40), "na$m_state": f(0, 1), "na$h_state": f(0, 1),
          "k$n_state": f(0, 1), "was_increasing": rng.random(n) < 0.5,
          "is_spiking": rng.random(n) < 0.2,
          "last_firing_time": np.where(rng.random(n) < 0.3,
                                       rng.integers(90, 100, n),
                                       -1).astype(np.int32),
          "nt$t": f(0, 1, (n, 3)), "rec$r": f(0, 1, (n, 3)),
          "nt$mask": rng.random((n, 3)) < (0.8 if nonuniform else 1.0),
          "rec$mask": rng.random((n, 3)) < (0.8 if nonuniform else 1.0)}
    for k, v in BASE.items():
        st[k] = (np.float32(v) * scale((n,))).astype(np.float32)
    for k in hk.nt_param_keys(nt) + hk.rec_param_keys(rec):
        st[k] = (np.asarray(TYPED[k], np.float32)
                 * scale((n, 3))).astype(np.float32)
    return st, g


def run_pallas(st, g, rows, cols, clock0, k, el, pl, nt, rec):
    """`fused_hh_multistep` on the inputs, returned in the state's layout."""
    def p2(key):
        return jnp.asarray(st[key].reshape(rows, cols))

    def p3(key):
        return jnp.asarray(np.moveaxis(st[key].reshape(rows, cols, 3), -1, 0))

    def s3(keys):
        return jnp.concatenate([p3(key) for key in keys])

    out = pallas_hh.fused_hh_multistep(
        p2("v"), p2("na$m_state"), p2("na$h_state"), p2("k$n_state"),
        p2("was_increasing").astype(jnp.float32),
        p2("is_spiking").astype(jnp.float32), p2("last_firing_time"),
        p3("nt$t"), p3("rec$r"),
        jnp.stack([p2(key) for key in pallas_hh.PARAM_ORDER]),
        s3(pallas_hh._nt_param_keys(nt)), p3("nt$mask").astype(jnp.float32),
        s3(pallas_hh._rec_param_keys(rec)),
        p3("rec$mask").astype(jnp.float32), g.weights,
        g.mask.astype(jnp.float32), g.in_deg, clock0,
        jnp.asarray([RULE[key] for key in pallas_hh.STDP_KEYS], jnp.float32),
        offsets=g.offsets, n_steps=k, electrical=el, plastic=pl,
        nt_kind=nt, rec_kind=rec)
    out = [np.asarray(o) for o in out]

    def back3(x):
        return np.moveaxis(x, 0, -1).reshape(-1, 3)

    fields = {"v": out[0], "na$m_state": out[1], "na$h_state": out[2],
              "k$n_state": out[3], "was_increasing": out[4] > 0,
              "is_spiking": out[5] > 0, "last_firing_time": out[6],
              "na$current": out[10][0], "k$current": out[10][1],
              "kleak$current": out[10][2]}
    fields = {key: x.reshape(-1) for key, x in fields.items()}
    fields.update({"nt$t": back3(out[7]), "rec$r": back3(out[8]),
                   "rec$current": back3(out[9])})
    return fields, out[11]


def twin_args(st, g, clock0, k, el, pl, nt, rec, device="cpu"):
    state = {key: torch.from_numpy(np.array(x)).to(device)
             for key, x in st.items()}
    return (state, torch.from_numpy(np.array(g.weights)).to(device),
            torch.from_numpy(np.array(g.mask)).to(device),
            torch.from_numpy(np.array(g.in_deg)).to(device), g.offsets,
            clock0, k, el, nt, rec, RULE if pl else None)


KINDS = [(nt, rec) for nt in hk.KINETICS for rec in hk.KINETICS]


@pytest.mark.parametrize("nt,rec", KINDS)
@pytest.mark.parametrize("shape,k,el,pl", [
    ((16, 16), 16, True, True), ((12, 10), 7, True, False),
    ((12, 10), 16, False, True), ((16, 16), 7, False, False)])
def test_twin_matches_pallas_kernel(shape, k, el, pl, nt, rec):
    """Every kinetics pair against 16^2 and 12 x 10 lattices with
    non-uniform parameters, K = 16 and 7, electrical and plasticity on and
    off; neurons fire in every case and STDP moves weights."""
    rows, cols = shape
    seed = 3 + 7 * KINDS.index((nt, rec)) + k + 2 * el + pl
    st, g = make_inputs(rows, cols, seed, nt, rec)
    want, wweights = run_pallas(st, g, rows, cols, 100, k, el, pl, nt, rec)
    got, gweights = hk.hh_steps_reference(
        *twin_args(st, g, 100, k, el, pl, nt, rec))
    for key in hk.STATE_KEYS + hk.CURRENT_KEYS:
        if want[key].dtype in (np.int32, np.bool_):
            np.testing.assert_array_equal(got[key].numpy(), want[key],
                                          err_msg=key)
        else:
            rtol = CURRENT_RTOL if key in ("na$current", "k$current") \
                else RTOL
            np.testing.assert_allclose(got[key].numpy(), want[key],
                                       rtol=rtol, atol=ATOL, err_msg=key)
    np.testing.assert_allclose(gweights.numpy(), wweights, rtol=RTOL,
                               atol=ATOL)
    assert (want["last_firing_time"] >= 100).sum() > 5
    if pl:
        assert np.abs(wweights - np.asarray(g.weights)).max() > 0.1


# -- the Lattice on the HH route against the JAX Lattice's Pallas route -----


@pytest.mark.parametrize("plastic", [True, False])
def test_lattice_hh_route_matches_jax_pallas(plastic):
    """100 steps of the JAX package's HH test lattice: 6 calls of K = 16
    and a remainder of 4, each side through its kernel (the twin here, the
    TPU kernel in interpret mode there)."""
    j = jax_hh_lattice(plastic=plastic, use_pallas=True)
    t = lattice_from(j, device="cpu")
    t.use_kernel = True
    j.run_lattice(100)
    t.run_lattice(100)
    assert t._last_run_fused == j._last_run_fused == "hh"
    assert_hh_match(t, j, RTOL, ATOL)
    assert (t.state["last_firing_time"].numpy() >= 0).any()


def test_lattice_hh_route_remainder_and_repeat():
    """37 then 19 steps: remainder calls, and state (spikes and
    was_increasing included) carried from one run to the next.  Floats
    within 5e-3 (mid-upstroke at step 56, see the module docstring), firing
    times and was_increasing equal."""
    j = jax_hh_lattice(plastic=True, use_pallas=True)
    t = lattice_from(j, device="cpu")
    t.use_kernel = True
    for n in (37, 19):
        j.run_lattice(n)
        t.run_lattice(n)
    assert t.internal_clock == 56
    assert_hh_match(t, j, 5e-3, 5e-3)


def test_lattice_routes_count_kernel_calls_only_on_cuda():
    """On the CPU the wrapper runs the twin and counts no launch; the auto
    setting keeps the plain route there."""
    j = jax_hh_lattice(8, 8, plastic=False)
    t = lattice_from(j, device="cpu")
    before = hk.LAUNCHES
    t.use_kernel = True
    t.run_lattice(20)
    assert t._last_run_fused == "hh" and hk.LAUNCHES == before
    t.use_kernel = None
    t.run_lattice(3)
    assert t._last_run_fused is False


# -- the wrapper and the gate -------------------------------------------------


def test_wrapper_on_cpu_runs_the_twin():
    st, g = make_inputs(9, 11, 4, "approximate", "destexhe")
    args = twin_args(st, g, 7, 5, True, True, "approximate", "destexhe")
    got = hk.hh_steps(*args)
    want = hk.hh_steps_reference(*args)
    for key in hk.STATE_KEYS + hk.CURRENT_KEYS:
        torch.testing.assert_close(got[0][key], want[0][key], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    # the inputs are left as they were
    np.testing.assert_array_equal(args[0]["v"].numpy(), st["v"])
    np.testing.assert_array_equal(args[1].numpy(), np.asarray(g.weights))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    st, g = make_inputs(6, 6, 5, "destexhe", "destexhe")
    state, weights, mask, in_deg, offsets = twin_args(
        st, g, 0, 2, True, True, "destexhe", "destexhe")[:5]

    def call(**kw):
        args = dict(state=state, weights=weights, mask=mask, in_deg=in_deg,
                    offsets=offsets, clock0=0, n_steps=2, electrical=True,
                    nt_kind="destexhe", rec_kind="destexhe")
        args.update(kw)
        return hk.hh_steps(**args)

    for key, bad in (("v", state["v"].double()),
                     ("last_firing_time", state["last_firing_time"].long()),
                     ("was_increasing", state["was_increasing"].float()),
                     ("nt$t", state["nt$t"].t()),          # not contiguous
                     ("rec$mask", state["rec$mask"][:, :2])):
        with pytest.raises(ValueError):
            call(state={**state, key: bad})
    with pytest.raises(ValueError):
        call(state={k: v for k, v in state.items() if k != "rec$alpha"})
    with pytest.raises(ValueError):
        call(weights=weights[:3])                # planes != offsets
    with pytest.raises(ValueError):
        call(n_steps=0)
    with pytest.raises(ValueError):
        call(nt_kind="bounded")
    many = tuple((dr, dc) for dr in range(-4, 5) for dc in range(-4, 5))
    with pytest.raises(ValueError):
        call(offsets=many, weights=torch.zeros((len(many), 6, 6)),
             mask=torch.zeros((len(many), 6, 6), dtype=torch.bool))


def test_supports_mirrors_jax_gate():
    """The port's gate against `pallas_hh.supports` (less its VMEM
    check) on models, kinetics, graphs, switches and rules."""
    jsg = jg.StencilGraph.build(4, 4, jg.radius_offsets(1.0))
    tsg = snt.StencilGraph.build(4, 4, jg.radius_offsets(1.0))
    tsparse = snt.SparseGraph.empty(16)
    cases = [(nt, rec) for nt in ("destexhe", "approximate", "bounded")
             for rec in ("destexhe", "approximate", "bounded")]
    for nt, rec in cases:
        for chem, plastic, rule in ((True, False, "stdp"),
                                    (False, False, "stdp"),
                                    (True, True, "stdp"),
                                    (True, True, "rstdp")):
            jm, tm = snn.HodgkinHuxley(nt, rec), snt.HodgkinHuxley(nt, rec)
            jr = snn.STDP() if rule == "stdp" else snn.RewardModulatedSTDP()
            tr = snt.STDP() if rule == "stdp" else snt.RewardModulatedSTDP()
            want = pallas_hh.supports(jm, jsg, chem, plastic, jr)
            assert hk.supports(tm, tsg, chem, plastic, tr) == want
            assert not hk.supports(tm, tsparse, chem, plastic, tr)
    assert not hk.supports(snt.Izhikevich(), tsg, True, False, snt.STDP())
    wide = snt.StencilGraph.build(
        12, 12, tuple((dr, dc) for dr in range(-4, 5) for dc in range(-4, 5)))
    assert not hk.supports(snt.HodgkinHuxley(), wide, True, False, snt.STDP())


# -- on a CUDA card only ------------------------------------------------------


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("nt,rec", KINDS)
@pytest.mark.parametrize("shape,k,el,pl", [
    ((64, 64), 16, True, True), ((130, 100), 7, False, True),
    ((64, 64), 16, True, False)])
def test_cuda_kernel_matches_twin(shape, k, el, pl, nt, rec):
    """Built with -fmad=false, with `kernel_exp` on both sides, the kernel
    rounds as the twin does: equal (checked at rtol 1e-6, atol 1e-5, the
    other kernels' card tolerance)."""
    _needs_cuda()
    st, g = make_inputs(*shape, 6, nt, rec)
    args = twin_args(st, g, 100, k, el, pl, nt, rec, device="cuda")
    before = hk.LAUNCHES
    got = hk.hh_steps(*args)
    torch.cuda.synchronize()
    assert hk.LAUNCHES == before + 1
    want = hk.hh_steps_reference(*args)
    for key in hk.STATE_KEYS + hk.CURRENT_KEYS:
        torch.testing.assert_close(got[0][key], want[0][key], rtol=1e-6,
                                   atol=1e-5, msg=key)
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-5)
    # the per-step design too (with STDP the fused schedule is the default)
    per_step = hk.hh_steps(*args, _per_step=True)
    for key in hk.STATE_KEYS + hk.CURRENT_KEYS:
        torch.testing.assert_close(per_step[0][key], want[0][key], rtol=1e-6,
                                   atol=1e-5, msg=key)
    torch.testing.assert_close(per_step[1], want[1], rtol=1e-6, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("nt,rec", KINDS)
@pytest.mark.parametrize("n_steps", [1, 2, 16, 17])
def test_cuda_fused_stdp_schedule_matches_twin(n_steps, nt, rec):
    """The firing form with STDP: the fused schedule (K + 1 launches) and
    the per-step design (2 K launches) on a 33 x 70 grid with -0.0
    weights, bit-equal to the twin, with the launches the C entry
    counted."""
    _needs_cuda()
    args = dict(hh_schedule_inputs(33, 70, seed=n_steps, nt=nt, rec=rec,
                                   device="cuda"), n_steps=n_steps)
    before = hk.STEP_LAUNCHES
    got = hk.hh_steps(**args)
    torch.cuda.synchronize()
    assert hk.STEP_LAUNCHES - before == n_steps + 1
    before = hk.STEP_LAUNCHES
    per_step = hk.hh_steps(**args, _per_step=True)
    assert hk.STEP_LAUNCHES - before == 2 * n_steps
    want = hk.hh_steps_reference(**args)
    for out in (got, per_step):
        assert bits_equal(out[1], want[1])
        for key in hk.STATE_KEYS + hk.CURRENT_KEYS:
            assert bits_equal(out[0][key], want[0][key]), key

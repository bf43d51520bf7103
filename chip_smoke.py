#!/usr/bin/env python3
"""Runs the PyTorch port's main path on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

The main path is the electrical Izhikevich lattice on a radius-2, 80%-keep
stencil graph at 512 x 512, through the entry points a user calls
(`Lattice` -> `populate` -> `connect_stencil` -> `apply` -> `run_lattice`).
Phases, one line each:

1. device: the card's name and power limit (nvidia-smi) and PyTorch's name;
2. build: nvcc builds the CUDA kernel from ``csrc/`` at first use;
3. kernel vs plain twin on the card, at 64^2, 130 x 100, 256^2, 512^2 and
   2048^2: lft and spikes equal, v and w within rtol 1e-6, atol 1e-5;
4. the main path: 512^2 for 2048 steps through the kernel (launch counter,
   finite v, neurons fired), 64 steps with a grid history, 2048^2 for 256
   steps;
5. 128^2 for 1000 steps: the kernel route on the card against the same
   fused route on the CPU, within the reference's CPU-vs-GPU criterion
   (2 mV, 2 steps), and against the plain route on the card, which sums in
   another association: the two may part only at a threshold tie;
6. neuron-updates/s of both routes at 512^2 and of the kernel route at
   2048^2, beside the card's name and power limit.

Then a line with the card's name and power limit as nvidia-smi gives them,
a JSON line with the kernel's launches, error and times, and last the JSON
contract line.  Any failure raises, and the exit code is not 0.  Without a
CUDA device the script exits with an error before it prints any result.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

RTOL, ATOL = 1e-6, 1e-5
# Largest |dv| (mV) between the fused and the plain route before their first
# threshold tie; 1000 steps at up to 64 x 64 keep it below 3e-5.
DRIFT = 1e-3
UNIFORM = dict(a=0.02, b=0.2, c=-55.0, d=8.0, v_th=30.0,
               gap_conductance=10.0, tau_m=1.0, c_m=100.0, dt=0.1)
# Shapes of the phases; CASES are ((rows, cols), K, emit, uniform params).
MAIN, MAIN_STEPS, HIST_STEPS = (512, 512), 2048, 64
BIG, BIG_STEPS = (2048, 2048), 256
CMP, CMP_STEPS = (128, 128), 1000
CASES = [((64, 64), 1, False, True), ((64, 64), 16, True, True),
         ((130, 100), 16, True, False), ((256, 256), 16, True, False),
         (MAIN, 16, False, True), (BIG, 8, False, True)]
REPLACES = ("spiking_neural_networks_tpu/ops/pallas_stencil.py:251",
            "spiking_neural_networks_tpu/ops/pallas_stencil.py:94",
            "spiking_neural_networks_tpu/ops/pallas_stencil.py:482")


def say(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def kernel_inputs(snt, rows, cols, seed, uniform):
    """Planes on the card for one kernel call, made from ``seed``."""
    rng = np.random.default_rng(seed)
    g = snt.StencilGraph.build(rows, cols, snt.radius_offsets(2.0),
                               keep_prob=0.8, seed=seed + 1, device="cuda")
    params = {k: np.full((rows, cols), v, np.float32)
              for k, v in UNIFORM.items()}
    if not uniform:
        params["a"] = rng.uniform(0.01, 0.03, (rows, cols)).astype(np.float32)
        params["d"] = rng.uniform(6, 10, (rows, cols)).astype(np.float32)
        params["v_th"] = rng.uniform(25, 35, (rows, cols)).astype(np.float32)
    lft = np.where(rng.random((rows, cols)) < 0.2, 5, -1).astype(np.int32)
    cuda = lambda x: torch.from_numpy(x).cuda()
    return dict(
        v=cuda(rng.uniform(-65, 30, (rows, cols)).astype(np.float32)),
        w=cuda(rng.uniform(20, 40, (rows, cols)).astype(np.float32)),
        lft=cuda(lft), weights=g.weights, in_deg=g.in_deg,
        params={k: cuda(p) for k, p in params.items()}, offsets=g.offsets)


def call(fn, inp, clock0, n_steps, emit):
    return fn(inp["v"], inp["w"], inp["lft"], inp["weights"], inp["in_deg"],
              inp["params"], inp["offsets"], clock0, n_steps, emit)


def event_ms(fn, reps):
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main_lattice(snt, rows, cols, use_kernel=None, device="cuda"):
    """The bench configuration: gap 10, radius 2, keep 0.8, graph seed 7,
    v0 uniform in [-65, 30) from ``default_rng(1)``."""
    lat = snt.Lattice(snt.Izhikevich(), device=device)
    lat.populate(rows, cols, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=7)
    v0 = np.random.default_rng(1).uniform(-65.0, 30.0, rows * cols)
    lat.apply(lambda s: {**s, "v": torch.as_tensor(v0, dtype=torch.float32,
                                                   device=lat.device)})
    lat.use_kernel = use_kernel
    return lat


def run_synced(lat, n):
    t0 = time.perf_counter()
    lat.run_lattice(n)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on a GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import spiking_neural_networks_tpu_torch as snt
    check(os.path.dirname(os.path.abspath(snt.__file__))
          == os.path.join(here, "spiking_neural_networks_tpu_torch"),
          f"imported the package from {snt.__file__}, not from the checkout "
          f"beside this script")
    from spiking_neural_networks_tpu_torch import _build
    from spiking_neural_networks_tpu_torch.ops import stencil_kernels as sk

    # 1. device
    smi = card()
    name = torch.cuda.get_device_name(0)
    say(f"[1 device] nvidia-smi: {smi} | torch: {name} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | "
        f"devices {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.load()
    load_s = time.perf_counter() - t0
    check(lib.izh_stencil_max_offsets() == sk.MAX_OFFSETS,
          "MAX_OFFSETS differs between the CUDA source and the wrapper")
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    nvcc = "cached" if _build.build_seconds is None \
        else f"{_build.build_seconds:.2f} s"
    say(f"[2 build] nvcc {nvcc}, load {load_s:.2f} s, "
        f"{os.path.basename(_build.library_path())}; ptxas: {' / '.join(ptxas)}")

    # 3. kernel vs plain twin on the card
    max_err, times = 0.0, {}
    for seed, ((rows, cols), k, emit, uniform) in enumerate(CASES):
        inp = kernel_inputs(snt, rows, cols, seed, uniform)
        got = call(sk.izhikevich_stencil_steps, inp, 100, k, emit)
        torch.cuda.synchronize()
        want = call(sk.izhikevich_stencil_steps_reference, inp, 100, k, emit)
        torch.cuda.synchronize()
        dv = (got[0] - want[0]).abs().max().item()
        dw = (got[1] - want[1]).abs().max().item()
        dpre = (got[4] - want[4]).abs().max().item() if emit else 0.0
        lft_bad = int((got[2] != want[2]).sum())
        spk_bad = int((got[3] != want[3]).sum())
        say(f"[3 kernel-vs-twin] {rows}x{cols} K={k} emit={emit} "
            f"uniform={uniform}: max|dv| {dv:.3g} max|dw| {dw:.3g} "
            f"max|dv_pre| {dpre:.3g} lft mismatches {lft_bad} "
            f"spike mismatches {spk_bad} fired {int(got[3].sum())}")
        check(lft_bad == 0 and spk_bad == 0, "lft or spikes differ")
        for g, w_ in zip(got[:2] + ((got[4],) if emit else ()),
                         want[:2] + ((want[4],) if emit else ())):
            torch.testing.assert_close(g, w_, rtol=RTOL, atol=ATOL)
        check(all(bool(torch.isfinite(x).all()) for x in got[:2]),
              "non-finite kernel output")
        max_err = max(max_err, dv, dw, dpre)
        if (rows, cols) in (MAIN, BIG):
            times[rows, cols] = (
                event_ms(lambda: call(sk.izhikevich_stencil_steps, inp, 100,
                                      k, False), 20) / k,
                event_ms(lambda: call(sk.izhikevich_stencil_steps_reference,
                                      inp, 100, k, False), 3) / k)
            say(f"[3 kernel-vs-twin] {rows}x{cols} K={k} per step: kernel "
                f"{times[rows, cols][0] * 1e3:.3f} us, plain twin "
                f"{times[rows, cols][1] * 1e3:.3f} us; card {smi}")
        del inp, got, want

    # 4. the main path
    lat = main_lattice(snt, *MAIN)
    sk.LAUNCHES = 0
    lat.run_lattice(MAIN_STEPS)
    torch.cuda.synchronize()
    launches = sk.LAUNCHES
    v = lat.state["v"]
    fired = int((lat.state["last_firing_time"] >= 0).sum())
    say(f"[4 main path] {MAIN[0]}x{MAIN[1]} run_lattice({MAIN_STEPS}): route "
        f"{lat._last_run_fused}, kernel calls {launches}, v finite "
        f"{bool(torch.isfinite(v).all())}, v range [{v.min().item():.3f}, "
        f"{v.max().item():.3f}], fired {fired} of {lat.n}")
    check(lat._last_run_fused == ("kernel", False), "main path missed the kernel")
    want_calls = math.ceil(MAIN_STEPS / sk.STEPS_PER_LAUNCH)
    check(launches == want_calls, f"expected {want_calls} kernel calls")
    check(bool(torch.isfinite(v).all()) and fired > 0, "bad main-path state")
    lat.update_grid_history = True
    lat.run_lattice(HIST_STEPS)
    hist = np.stack(lat.grid_history.history)
    say(f"[4 main path] grid history {HIST_STEPS} steps: shape {hist.shape}, "
        f"route {lat._last_run_fused}, finite {bool(np.isfinite(hist).all())}")
    check(hist.shape == (HIST_STEPS, *MAIN) and np.isfinite(hist).all(),
          "bad grid history")
    check(lat._last_run_fused == ("kernel", True), "history run missed the kernel")
    big = main_lattice(snt, *BIG)
    big.run_lattice(BIG_STEPS)
    torch.cuda.synchronize()
    bv = big.state["v"]
    bfired = int((big.state["last_firing_time"] >= 0).sum())
    say(f"[4 main path] {BIG[0]}x{BIG[1]} run_lattice({BIG_STEPS}): route "
        f"{big._last_run_fused}, v finite {bool(torch.isfinite(bv).all())}, "
        f"fired {bfired} of {big.n}")
    check(big._last_run_fused == ("kernel", False)
          and bool(torch.isfinite(bv).all()) and bfired > 0,
          "bad large-lattice run")
    del lat, big

    # 5. the kernel route on the card against (a) the same fused route on
    # the CPU, under the reference's CPU-vs-GPU criterion, and (b) the plain
    # route on the card, whose gather sums in another association
    runs = {}
    for key, device, use_kernel in (("kernel", "cuda", None),
                                    ("cpu", "cpu", True),
                                    ("plain", "cuda", False)):
        lat = main_lattice(snt, *CMP, use_kernel=use_kernel, device=device)
        lat.update_grid_history = True
        lat.run_lattice(CMP_STEPS)
        runs[key] = (np.stack(lat.grid_history.history).reshape(CMP_STEPS, -1),
                     lat.field("last_firing_time").reshape(-1).astype(np.int64),
                     lat._last_run_fused)
    check(runs["kernel"][2] == runs["cpu"][2] == ("kernel", True)
          and runs["plain"][2] is False, "wrong routes")
    hk, lk, _ = runs["kernel"]
    hc, lc, _ = runs["cpu"]
    dv_cpu, dlft_cpu = float(np.abs(hk - hc).max()), int(np.abs(lk - lc).max())
    say(f"[5 kernel-vs-cpu] {CMP[0]}x{CMP[1]} {CMP_STEPS} steps, fused route "
        f"on the card vs on the CPU: max|dv| {dv_cpu:.4g} mV, max|dlft| "
        f"{dlft_cpu} steps")
    check(dv_cpu <= 2.0 and dlft_cpu <= 2,
          "card vs CPU outside the 2 mV / 2 step criterion")
    # Across associations the two routes drift apart by rounding until a
    # neuron sitting at threshold fires in one route and not in the other;
    # spiking dynamics then spread the one-step shift.  Require that the
    # routes agree within DRIFT until that first tie, that every neuron
    # leaving DRIFT there is such a tie (one route reset to c, the other
    # within DRIFT of v_th), and that the divergence stays local.
    hp, lp, _ = runs["plain"]
    d = np.abs(hk - hp)
    dvs = d.max(axis=1)
    over = np.nonzero(dvs > 1e-4)[0]
    s0 = int(np.argmax(dvs > DRIFT)) if (dvs > DRIFT).any() else None
    gaps = []                 # |v - v_th| of the route that did not fire
    if s0 is not None:
        c, v_th = (snt.Izhikevich.FIELDS[k] for k in ("c", "v_th"))
        for j in np.nonzero(d[s0] > DRIFT)[0]:
            a, b = hk[s0, j], hp[s0, j]
            other = b if a == c else a if b == c else None
            gaps.append(np.inf if other is None else abs(float(other) - v_th))
    ties_ok = max(gaps, default=0.0) <= DRIFT
    outside = int((d > 2.0).any(axis=0).sum())
    n = CMP[0] * CMP[1]
    fk, fp = int((lk >= 0).sum()), int((lp >= 0).sum())
    say(f"[5 kernel-vs-plain] {CMP[0]}x{CMP[1]} {CMP_STEPS} steps, fused vs "
        f"plain association on the card: max|dv| {dvs.max():.4g} mV, "
        f"max|dlft| {int(np.abs(lk - lp).max())} steps, first step with "
        f"|dv| > 1e-4: {int(over[0]) if len(over) else 'none'}, first tie "
        f"step {s0} ({len(gaps)} neurons, max |v - v_th| {max(gaps, default=0):.3g} mV), neurons ever outside "
        f"2 mV: {outside} of {n}, fired {fk} vs {fp}")
    check(ties_ok, "the routes parted at a step that is not a threshold tie")
    check(outside <= n // 100 and abs(fk - fp) <= n // 100,
          "the routes' divergence spread beyond 1% of the lattice")

    # 6. times: wall clock to a synchronise, median of 5 after a warm-up;
    # the kernel's event time per step from phase 3 over the wall time per
    # step is the share of the run the card spent in the kernel
    def warm(shape, use_kernel, steps):
        lat = main_lattice(snt, *shape, use_kernel=use_kernel)
        run_synced(lat, steps)
        return lat

    def rate(shape, secs, steps):
        n = shape[0] * shape[1]
        return (f"{n * steps / secs:.4e} neuron-updates/s "
                f"({secs / steps * 1e6:.3f} us/step")

    kern, plain = warm(MAIN, None, MAIN_STEPS), warm(MAIN, False, MAIN_STEPS)
    tk, tp = [], []
    for rep in range(5):                             # in turns
        order = [(kern, tk), (plain, tp)] if rep % 2 == 0 \
            else [(plain, tp), (kern, tk)]
        for lat, out in order:
            out.append(run_synced(lat, MAIN_STEPS))
    check(kern._last_run_fused == ("kernel", False)
          and plain._last_run_fused is False, "timed the wrong routes")
    mk, mp = float(np.median(tk)), float(np.median(tp))
    busy = times[MAIN][0] * MAIN_STEPS / (mk * 1e3)
    say(f"[6 times] {MAIN[0]}x{MAIN[1]} {MAIN_STEPS} steps, median of 5: "
        f"kernel route {rate(MAIN, mk, MAIN_STEPS)}; kernel time / wall "
        f"{busy:.3f}), plain route {rate(MAIN, mp, MAIN_STEPS)}); card {smi}")
    del kern, plain
    big = warm(BIG, None, BIG_STEPS)
    mb = float(np.median([run_synced(big, BIG_STEPS) for _ in range(5)]))
    busy = times[BIG][0] * BIG_STEPS / (mb * 1e3)
    say(f"[6 times] {BIG[0]}x{BIG[1]} {BIG_STEPS} steps, median of 5: "
        f"kernel route {rate(BIG, mb, BIG_STEPS)}; kernel time / wall "
        f"{busy:.3f}); card {smi}")
    del big

    say(smi)
    say(json.dumps({"kernels": [{
        "name": "izhikevich_stencil_steps", "route": "cuda",
        "source": "spiking_neural_networks_tpu_torch/csrc/izhikevich_stencil.cu",
        "replaces": REPLACES[0], "also_replaces": list(REPLACES[1:]),
        "launches": launches, "max_abs_err": max_err,
        "ms": times[MAIN][0] * sk.STEPS_PER_LAUNCH,
        "plain_ms": times[MAIN][1] * sk.STEPS_PER_LAUNCH}]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

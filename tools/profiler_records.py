"""How many kernel records torch.profiler keeps, session after session, in
one process on a CUDA card: for a kernel of the package's library and for
two libraries that the DSL arm generates, one loaded before the first
session and one loaded after ``--early`` sessions.

Each session is `chip_smoke.kernel_records`'s: a warm-up cycle, then one
kept cycle of four 16-step calls of a 512^2 lattice (4 launches of the
persistent model kernel a cycle).  The script prints, for each block of
``--block`` sessions, the mean records each kernel kept out of 4, and then
one JSON line of every count.  Run from the repository's root:

    python3 tools/profiler_records.py [--early 400] [--late 100]
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def records(fn, mine):
    """The records of kernels whose names hold one of ``mine`` in the kept
    cycle of one profiler session around ``fn``."""
    from torch.profiler import ProfilerActivity, profile, schedule
    kept = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: kept.append(p.key_averages())) \
            as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return sum(e.count for e in kept[-1]
               if e.device_type == torch.autograd.DeviceType.CUDA
               and any(m in e.key for m in mine))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--early", type=int, default=400,
                    help="sessions before the late library is loaded")
    ap.add_argument("--late", type=int, default=100,
                    help="sessions after it is loaded")
    ap.add_argument("--block", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profiler_records: no CUDA device")
    import spiking_neural_networks_tpu_torch as snt
    from spiking_neural_networks_tpu_torch.ops import dsl_kernels as dk
    n = 4 * 16
    # both generated libraries built now, the late one loaded only later
    early_name, late_name = "DSLIzhikevich", "KernelBranchy"
    dk.build([cs.dsl_model(snt, early_name), cs.dsl_model(snt, late_name)])
    lats = {"package": cs.main_lattice(snt, 512, 512),
            "dsl_early": cs.dsl_lattice(snt, early_name, 512, 512)}
    for lat in lats.values():
        lat.run_lattice(16)
    torch.cuda.synchronize()
    counts = {k: [] for k in ("package", "dsl_early", "dsl_late")}

    def session(key):
        lat = lats[key]
        counts[key].append(records(lambda: lat.run_lattice(n), ("model_",)))

    for i in range(args.early + args.late):
        if i == args.early:
            lats["dsl_late"] = cs.dsl_lattice(snt, late_name, 512, 512)
            lats["dsl_late"].run_lattice(16)
            torch.cuda.synchronize()
        for key in lats:
            session(key)
        if (i + 1) % args.block == 0:
            lo = i + 1 - args.block
            print(f"sessions {lo}-{i}: mean records of 4 " + ", ".join(
                f"{k} {sum(c[-args.block:]) / len(c[-args.block:]):.2f}"
                for k, c in counts.items() if c), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "early": args.early, "late": args.late,
                      "counts": counts}))


if __name__ == "__main__":
    main()

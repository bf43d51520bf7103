#!/usr/bin/env python3
"""The control of the check that decides ``correct``: the reference put in
the program's place and computed in the precision below the one the
configuration states (bfloat16 for float32), at the cell's own size; or,
with ``--fault``, the reference in the configuration's precision with a
fault planted in it.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \\
        [--requests N] [--fault frozen_synapses] [--device cuda]

For each seed it draws the cell's inputs as a run does (through the
traffic kind's ``inputs``), computes ``--requests`` of the cell's requests
(by default as many as a run checks) with the reference, and again as the
control, and prints one JSON line a seed: the numbers `snnbench.check`
computes with the control standing for the program's trial, each beside
its limit, and ``correct`` as a run would give it.  The control must come
out not correct.  Benchmark runs never run it.

Faults (``--fault``): those that the cell's reference module plants, its
``FAULTS`` mapping of names to context managers, each of which breaks the
reference while it computes the control.  ``izhikevich_lattice``'s:

* ``frozen_synapses``: R-STDP leaves the weights, the traces and the visit
  counter as they were while the neurons step.
"""

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

LOWER = {"float32": "bfloat16", "float64": "float32"}


def control_numbers(cell, seed, n_requests, device, fault=None):
    """The compared numbers of the control (or of the reference with
    ``fault`` planted) over ``n_requests`` requests of run ``seed`` (the
    largest of each)."""
    import torch
    from snnbench import check
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    graph, draws = cell.kind.inputs(cfg, traffic, seed, dev)
    dtype = torch.float32 if fault else getattr(torch, LOWER[cfg["dtype"]])
    planted = cell.reference.FAULTS[fault] if fault \
        else contextlib.nullcontext

    rows_cmp = []
    for _ in range(n_requests):
        x = draws.next()
        ref = cell.trial(cfg, traffic, graph, x)
        with planted():
            ctl = cell.trial(cfg, traffic, graph, x, dtype)
        rows_cmp.append(check.compare(cell, ctl, ref, graph.mask))
    return check.merge(rows_cmp)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--fault", default=None,
                    help="a name in the FAULTS of the cell's reference")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    from snnbench import catalog, check
    cell = catalog.Catalog().cell(args.workload)
    faults = sorted(getattr(cell.reference, "FAULTS", {}))
    if args.fault is not None and args.fault not in faults:
        ap.error(f"the reference of {args.workload} plants no fault "
                 f"{args.fault!r}; it plants {faults}")
    n = args.requests or int(cell.traffic["check_requests"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums = control_numbers(cell, seed, n, args.device, args.fault)
        ok, checks = check.verdict(nums, check.limits_of(cell))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.fault or LOWER[
                              cell.config["dtype"]],
                          "requests": n, "correct": ok, "checks": checks,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

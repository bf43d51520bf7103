#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port, one cell a run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds the port
(``spiking_neural_networks_tpu_torch``), on a machine with the NVIDIA GPUs
the cell asks for.  The cell's configuration, traffic mix, reference and
metrics are found by the names in ``BENCHMARK.json``.  It loads, warms up,
measures for ``--seconds``, checks a sample of the window's requests
against the plain reference, and prints one JSON object as the last line
of standard output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy time and the
profiled slice's breakdown.  The numbers compared for ``correct`` are the
last lines of standard error and the last key of that object.

It exits with another code than 0, and prints no result, without the GPUs
the cell asks for, without the port in the checkout, or when the JAX
package or JAX has been loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every cache a run writes stays at a fixed path inside the checkout
CACHE = os.path.join(ROOT, ".bench_cache")
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(CACHE, _sub)
# load from one process with few threads
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["USE_FLAX"] = "0"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    sys.path.insert(0, HERE)
    from snnbench import catalog, session

    cell = catalog.Catalog().cell(args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"torch sees {torch.cuda.device_count()}")
        return 3
    try:
        session.import_port()
    except ImportError as e:
        log(f"the port is not in this checkout: {e}")
        return 4
    result = session.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T0, log=log)
    found = session.forbidden_modules()
    if found:
        log("modules of JAX or of the JAX package were loaded: "
            + ", ".join(found))
        return 5
    checks = result["checks"]
    for k, c in checks.items():
        log(f"{k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The benchmark's own tests: the harness on the CPU at small sizes (the
port's kernel routes run their plain twins there), and, marked ``cuda``,
what only the card can run.

    python -m pytest benchmark/tests -q
"""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)


@pytest.fixture
def card():
    """Skips unless a CUDA device is there (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels and the "
                    "benchmark's runs have no CPU mode)")


TINY = {
    "t_lattice": ("izh_stencil", {"kind": "lattice_run", "rows": 16,
                                  "cols": 16, "steps": 256}),
    "t_reward": ("izh_rstdp", {"kind": "reward_run", "rows": 16,
                               "cols": 16, "steps": 320, "reward": 0.5}),
    "t_loop": ("izh_rstdp", {"kind": "closed_loop", "rows": 10, "cols": 10,
                             "steps": 150,
                             "env": {"cue_neurons": 6, "cue_mv": 31.0,
                                     "target_rate": 0.08, "clip": 0.05,
                                     "keep": 0.9, "take": 0.1},
                             "limits": {"rewards_gap": 1e-5,
                                        "rate_gap": 1e-5,
                                        "synapses_off": 0.005}}),
}


def tiny_catalog(tmp_path, extra_metrics=()):
    """A catalog over a copy of the benchmark's data files in ``tmp_path``
    with the cells of `TINY` added (16 x 16 lattices of 256- and 320-step
    requests: a lattice first fires after 70-180 steps, and R-STDP moves
    weights on every seed by 320; the loop's 150-step episodes as its
    cell's, the cue firing at once) and every metric but the split ones
    (``name.part``) open to every cell."""
    from snnbench import catalog
    for sub in ("configs", "traffic", "metrics", "reference"):
        shutil.copytree(os.path.join(BENCH, sub), tmp_path / sub)
    spec = catalog.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for name, (cfg, mix) in TINY.items():
        mix = dict(mix, v0=[-65.0, 30.0], warmup_requests=1,
                   check_requests=2, trace_requests=1)
        (tmp_path / "traffic" / f"{name}.json").write_text(json.dumps(mix))
        spec["workloads"].append({"name": name, "config": cfg,
                                  "traffic": name, "chips": 1, "why": "t"})
    for group in ("end_to_end", "per_layer"):
        spec[group] = [dict(m) for m in spec[group] if "." not in m["name"]]
        for m in spec[group]:
            m.pop("workloads", None)
    spec["per_layer"] += list(extra_metrics)
    return catalog.Catalog(root=ROOT, bench_dir=str(tmp_path), spec=spec)


def run_cell(cat, name, seed=20261018, seconds=0.2, trace=False):
    import time
    from snnbench import session
    return session.run(cat.cell(name), seed, seconds, trace, "cpu",
                       time.perf_counter(), log=lambda *a: None, root=ROOT)

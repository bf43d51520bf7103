"""What only the card runs: one short run of each cell through the
benchmark's command, ``correct`` and its metrics."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_runs_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483711", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"

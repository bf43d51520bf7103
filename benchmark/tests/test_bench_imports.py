"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole), and the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "spiking_neural_networks_tpu"}
PORT = "spiking_neural_networks_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        assert PORT not in set(_imports(path)), path
    code = ("import sys; sys.path.insert(0, %r); "
            "from snnbench import catalog; "
            "catalog.Catalog().module('reference', 'izhikevich_lattice'); "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] == %r))" % (BENCH, PORT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=BENCH)
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_forbidden_module():
    """A whole run of a cell on the CPU, then the run's own guard."""
    code = (
        "import sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import conftest, tempfile, pathlib\n"
        "from snnbench import session\n"
        "cat = conftest.tiny_catalog(pathlib.Path(tempfile.mkdtemp()))\n"
        "r = conftest.run_cell(cat, 't_loop', trace=True)\n"
        "assert r['correct']\n"
        "print(session.forbidden_modules())\n"
        % (BENCH, os.path.join(BENCH, "tests")))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_fails_without_the_port_or_a_card(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files, the command exits with another code than 0 and prints no
    result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "izh512_long",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""

"""The PyTorch package stands apart from JAX: importing it loads no JAX
module, and neither its files nor ``chip_smoke.py`` import JAX."""

import os
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "spiking_neural_networks_tpu_torch")


def test_import_leaves_jax_out():
    code = ("import sys, spiking_neural_networks_tpu_torch\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'jax')\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_modules_import_with_jax_blocked():
    """The reference's surface, the trial pipeline, the support modules,
    fitting, the diagnostics, the native graph builder, checkpoints and
    profiling import with ``jax`` blocked (a None entry in ``sys.modules`` makes any
    ``import jax`` raise)."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['spiking_neural_networks_tpu'] = None\n"
            "import spiking_neural_networks_tpu_torch.lixirnet as ln\n"
            "from spiking_neural_networks_tpu_torch import (analysis, "
            "attractors, coupling)\n"
            "from spiking_neural_networks_tpu_torch.analysis import (eeg, "
            "correlation, peaks)\n"
            "from spiking_neural_networks_tpu_torch.utils import "
            "distribution\n"
            "from spiking_neural_networks_tpu_torch.experiments import "
            "bayesian_inference_rate_based as b\n"
            "from spiking_neural_networks_tpu_torch import (_native, "
            "diagnostics, fitting)\n"
            "from spiking_neural_networks_tpu_torch.utils import (checkpoint,"
            " profiling)\n"
            "from spiking_neural_networks_tpu_torch import why_not_fused\n"
            "assert fitting.fit_neuron_to_neuron and checkpoint.save_network "
            "and profiling.StepTimer and diagnostics.why_not_fused is "
            "why_not_fused and _native.WEIGHT_MODES\n"
            "assert b.ln is ln and ln.IzhikevichNeuronLattice\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_parallel_imports_without_jax():
    """`parallel` (sharding, pipelines, meshes across processes) and the
    multi-process test's worker import with ``jax`` blocked, and the
    package exports `parallel` as the JAX package's does."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['spiking_neural_networks_tpu'] = None\n"
            "import spiking_neural_networks_tpu_torch as snt\n"
            "from spiking_neural_networks_tpu_torch.parallel import (\n"
            "    lattice_sharding, mesh, multihost, pipeline, sharding)\n"
            "sys.path.insert(0, 'tests')\n"
            "import _torch_multihost_worker\n"
            "assert snt.parallel.shard_lattice and snt.parallel."
            "make_hybrid_mesh and pipeline.run_pipelined_with_reward\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'jax'"
            " and sys.modules[m] is not None)\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr



def test_core_imports_no_parallel_when_it_loads():
    """The core layer reaches `parallel` only through lazy imports in its
    ``shard`` / pipeline entry points and the ``_shard`` object, so
    `parallel` depends on core and not the reverse."""
    import ast
    offenders = []
    core = os.path.join(PKG, "core")
    for name in sorted(os.listdir(core)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(core, name)) as f:
            tree = ast.parse(f.read())
        for node in tree.body:
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.split(".")[0] == "parallel":
                offenders.append(name)
    assert not offenders, offenders

def test_no_file_imports_jax():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.]"
                         r"|(import|from)\s+spiking_neural_networks_tpu[\s.])",
                         re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        paths += [os.path.join(dirpath, n) for n in files if n.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as f:
            if pattern.search(f.read()):
                offenders.append(os.path.relpath(path, ROOT))
    assert not offenders, offenders


def test_chip_smoke_fails_without_a_card():
    """Without CUDA the smoke script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""


EXPERIMENTS = (
    "lsm_setup", "schizophrenia_simulation", "dopamine_liquid_interaction",
    "bayesian_inference_pipeline", "attractor_manifold",
    "grid_cell_electrochemical", "grid_cell_model", "tolman_eichenbaum",
    "heuristic_parameter_search", "isolated_liquid_pipeline",
    "hd_electrochemical_model_dopaminergic", "hd_electrochemical_model",
    "hd_electrochemical_model_no_turning", "hd_with_basin", "hd_attractor")


def test_experiments_import_without_jax_or_the_scripts():
    """The science pipelines import with ``jax``, the JAX package and every
    script of ``experiments/`` blocked, and those that use lixirnet use the
    port's."""
    blocked = ["jax", "spiking_neural_networks_tpu", "pipeline_setup"] \
        + list(EXPERIMENTS)
    code = ("import sys, importlib\n"
            f"for m in {blocked!r}:\n"
            "    sys.modules[m] = None\n"
            "import spiking_neural_networks_tpu_torch.lixirnet as ln\n"
            f"for name in {EXPERIMENTS!r}:\n"
            "    mod = importlib.import_module("
            "'spiking_neural_networks_tpu_torch.experiments.' + name)\n"
            "    assert getattr(mod, 'ln', ln) is ln, name\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'jax'"
            " and sys.modules[m] is not None)\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_experiments_import_their_siblings_relatively():
    """No pipeline reaches a script of ``experiments/`` by its bare name
    (``from pipeline_setup import``), and each runs on ``"cuda"`` unless
    asked for another device."""
    folder = os.path.join(PKG, "experiments")
    bare = re.compile(r"^\s*(from|import)\s+(" + "|".join(
        ("pipeline_setup",) + EXPERIMENTS) + r")\b", re.M)
    for name in EXPERIMENTS:
        with open(os.path.join(folder, name + ".py")) as f:
            src = f.read()
        assert not bare.search(src), name
        assert 'device="cuda"' in src, name


LIQUIDS = ("digits", "liquid_state_machine", "liquid_manifold_generation",
           "training_liquid_pipeline", "liquid_manifold_digits",
           "attractor_manifold_plot")
EXAMPLES = ("lattice", "eeg_psd", "lattice_network", "synaptic_pruning",
            "interacting_pools", "rstdp_lattice", "agent_environment",
            "lsm_architecture", "sharded_lattice", "pipelined_network",
            "stdp", "bcm", "raster", "hodgkin_huxley", "morris_lecar",
            "hopfield")


def test_entry_points_import_without_jax_sklearn_or_the_scripts():
    """The liquid pipelines, the plot and the examples import with
    ``jax``, the JAX package, scikit-learn and every script of
    ``experiments/`` and ``examples/`` blocked."""
    blocked = (["jax", "spiking_neural_networks_tpu", "sklearn",
                "pipeline_setup", "lsm_setup"] + list(EXPERIMENTS)
               + list(LIQUIDS) + list(EXAMPLES))
    names = ([f"experiments.{n}" for n in LIQUIDS]
             + [f"examples.{n}" for n in EXAMPLES])
    code = ("import sys, importlib\n"
            f"for m in {blocked!r}:\n"
            "    sys.modules[m] = None\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module("
            "'spiking_neural_networks_tpu_torch.' + name)\n"
            "from spiking_neural_networks_tpu_torch.experiments import "
            "digits\n"
            "assert digits.load_digits().data.shape == (1797, 64)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'sklearn') and sys.modules[m] is not None)\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_run_on_the_card_by_default():
    """No new entry point reaches scikit-learn or a script by its bare
    name, and each that builds lattices runs on ``"cuda"`` unless asked
    for another device (the plot and the digits build none)."""
    bare = re.compile(r"^\s*(from|import)\s+(sklearn|" + "|".join(
        ("pipeline_setup", "lsm_setup") + EXPERIMENTS + LIQUIDS)
        + r")\b", re.M)
    paths = [os.path.join(PKG, "experiments", n + ".py") for n in LIQUIDS] \
        + [os.path.join(PKG, "examples", n + ".py") for n in EXAMPLES]
    for path in paths:
        with open(path) as f:
            src = f.read()
        assert not bare.search(src), path
        if not path.endswith(("digits.py", "attractor_manifold_plot.py")) \
                or path.endswith("liquid_manifold_digits.py"):
            assert 'device="cuda"' in src or 'default="cuda"' in src, path

"""Builds the package's CUDA sources with nvcc and loads them with ctypes.

The library is built at first use, from every ``csrc/*.cu`` (with the
shared ``csrc/*.cuh`` headers), into
``_build/`` beside this file: one nvcc per source, all started together,
then one link into a shared library with a plain C interface for
``sm_90a`` (NVIDIA Hopper).  Its file name carries a hash of the sources,
headers and flags, so an edited source is rebuilt and a stale library is never
loaded.  Nothing is built when the package is imported.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -Xptxas -v -Xcompiler -fPIC -c -o <obj> csrc/<source>.cu   # each
    nvcc -shared -o _build/libsnn_kernels-<hash>.so <objs>

``-fmad=false`` keeps each multiply and add separately rounded, so the
kernels agree bit for bit with their plain PyTorch twins.

A generated source (``ops/dsl_kernels.py``: one functor from a DSL neuron
and the model kernel's C entries for it, including
``csrc/model_stencil.cuh``) builds the same way into a library of its own
under ``_build/dsl/``, named by a hash of its text, the headers and the
flags, so one DSL source builds once per machine (`load_generated`);
`build_generated` starts the nvcc runs of several sources together.

    nvcc <flags> -I csrc -shared -o _build/dsl/libsnn_dsl-<hash>.so <source>
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

from .utils import profiling

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(sorted(glob.glob(os.path.join(_HERE, "csrc", "*.cu"))))
HEADERS = tuple(sorted(glob.glob(os.path.join(_HERE, "csrc", "*.cuh"))))
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

GENERATED_DIR = os.path.join(BUILD_DIR, "dsl")
CSRC = os.path.join(_HERE, "csrc")

_lib = None
_generated = {}
# Set by the build that `load` runs in this process (None when the library
# was already built): wall seconds of the nvcc calls and their output,
# which holds ptxas's register and spill report of every kernel.
build_seconds = None
build_log = ""
# The same for the last `build_generated` round that compiled something:
# its wall seconds and nvcc's output, by library file name.
generated_seconds = None
generated_logs = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "CUDA kernels are built at first use and need the CUDA toolkit")
    return path


def library_path():
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libsnn_kernels-"
                                   f"{digest.hexdigest()[:16]}.so")


def _compile(out):
    global build_seconds, build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        jobs = []
        for src in SOURCES:
            obj = os.path.join(tmpdir, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            jobs.append((src, obj, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, cmd, proc in jobs:
            text = proc.communicate()[0]
            logs.append(f"== {os.path.basename(src)}\n{text}")
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{text}")
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = os.path.join(tmpdir, "lib.so")
        cmd = [nvcc, "-shared", "-o", tmp] + [obj for _, obj, _, _ in jobs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_seconds = time.perf_counter() - t0


def load():
    """The loaded kernel library, built first if needed, with the
    ``argtypes`` and ``restype`` of every exported function set."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not os.path.exists(path):
        with profiling.span("build.compile"):
            _compile(path)
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    pv, pi, pf = (ctypes.POINTER(vp), ctypes.POINTER(ci),
                  ctypes.POINTER(ctypes.c_float))
    for name in ("lp_max_offsets", "hh_max_offsets",
                 "model_stencil_max_offsets"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ci
    lib.izh_stencil_steps.argtypes = [
        vp, vp, vp,                         # v, w, lft
        vp, vp, pv,                         # weights, in_deg, params[9]
        vp, vp, vp,                         # buffer set 0
        vp, vp, vp,                         # buffer set 1
        vp, vp,                             # spikes, v_pre (nullable)
        pi, pi, ci,                         # dr, dc, n_off
        ci, ci, ci, ci,                     # rows, cols, clock0, n_steps
        pi, vp,                             # launched, stream
    ]
    lib.izh_stencil_steps.restype = ci
    lib.izh_stencil_limits.argtypes = [pi]
    lib.izh_stencil_limits.restype = None
    lib.izh_stencil_r2.argtypes = [pi, pi]
    lib.izh_stencil_r2.restype = None
    tiled = [
        vp, vp, vp,                         # v, w, lft
        vp, vp, pf,                         # weights, in_deg, scalars[9]
        vp, vp, vp,                         # buffer set 0
        vp, vp, vp,                         # buffer set 1
        vp, vp,                             # spikes, v_pre (nullable)
        pi, pi, ci,                         # dr, dc, n_off
        ci, ci, ci, ci,                     # rows, cols, clock0, n_steps
        ci, ci, ci, ci, ci,                 # tw, seg, kb, r, threads
        pi, vp,                             # launched, stream
    ]
    lib.izh_stencil_tiled.argtypes = tiled
    lib.izh_stencil_tiled.restype = ci
    # th, tw, kb, threads, cpt in place of tw, seg, kb, r, threads
    lib.izh_stencil_tiled2d.argtypes = tiled
    lib.izh_stencil_tiled2d.restype = ci
    lib.lattice_plasticity_steps.argtypes = [
        ci, ci, ci,                         # model, kind, with_reward
        pv, pv,                             # state_in[4], state_buf[8]
        vp, vp,                             # spikes, v_pre (nullable)
        vp, pv, ci,                         # in_deg, params, n_params
        vp, vp,                             # weights, mask
        vp, vp, vp,                         # traces c, dw, counter
        vp, vp,                             # dop_in, dop_steps
        pf, pf,                             # rule[9], rewards[n_steps]
        pi, pi, ci,                         # dr, dc, n_off
        ci, ci, ci, ci,                     # rows, cols, clock0, n_steps
        ci, pi, vp,                         # per_step, launched, stream
    ]
    lib.lattice_plasticity_steps.restype = ci
    lib.lattice_plasticity_env_step.argtypes = [
        ci, ci, ci, ci,                     # model, kind, edge, cell
        pv, pv, vp,                         # state_in[4], state_out[4], spikes
        vp, vp, vp, vp,                     # kept lft / spikes, edge's
        vp, pv, ci,                         # in_deg, params, n_params
        vp, vp,                             # weights, mask
        vp, vp, vp,                         # traces c, dw, counter
        vp, vp, vp,                         # dopamine read / write, reward
        vp, vp,                             # clock read / write
        pf,                                 # rule[9]
        pi, pi, ci,                         # dr, dc, n_off
        ci, ci,                             # rows, cols
        pi, vp,                             # launched, stream
    ]
    lib.lattice_plasticity_env_step.restype = ci
    lib.hh_chemical_steps.argtypes = [
        ci, ci, ci, ci,                     # nt, rec kinetics, elec, plastic
        pv, pv, pv,                         # state_in[9], buf[18], cur[4]
        pv,                                 # params[10]
        pv, ci, pv, ci,                     # nt / rec params and counts
        vp, vp,                             # nt$mask, rec$mask
        vp, vp, vp,                         # weights, mask, in_deg
        pf,                                 # rule[5]
        pi, pi, ci,                         # dr, dc, n_off
        ci, ci, ci, ci,                     # rows, cols, clock0, n_steps
        ci, pi, vp,                         # per_step, launched, stream
    ]
    lib.hh_chemical_steps.restype = ci
    bind_model_entries(lib)
    lib.net_limits.argtypes = [pi]
    lib.net_limits.restype = None
    lib.net_steps.argtypes = [
        ci, pi, pv,                         # lattices: count, ints, ptrs
        ci, pi, pv,                         # trains
        ci, pi, pv,                         # connections
        pf, ci, ci,                         # rule[5], clock0, n_steps
        pi, pv, pv,                         # chemical: ints[4], lat, train
        pf, ci, pf,                         # rrule[9], with_reward, rewards
        vp, vp,                             # dop_in, dop_steps
        vp,                                 # stream
    ]
    lib.net_steps.restype = ci
    lib.net_persistent_limits.argtypes = [pi]
    lib.net_persistent_limits.restype = None
    lib.net_persistent_info.argtypes = [ci, ci, pi]  # variant, smem, out
    lib.net_persistent_info.restype = ci
    lib.net_persistent_sync_probe.argtypes = [ci, ci, vp]
    lib.net_persistent_sync_probe.restype = ci
    lib.net_persistent_steps.argtypes = [
        ci, pi, pv,                         # lattices: count, ints, ptrs
        ci, pi, pv,                         # trains
        ci, pi, pv,                         # connections
        pf, pf,                             # rule[5], rrule[9] (nullable)
        pi,                                 # chemical ints[4]
        ci, ci, ci,                         # clock0, n_steps, with_reward
        pf, vp, vp,                         # rewards, dop_in, dop_steps
        ci,                                 # smem
        vp,                                 # stream
    ]
    lib.net_persistent_steps.restype = ci
    _lib = lib
    return lib


def bind_model_entries(lib):
    """Set the ``argtypes`` and ``restype`` of the model kernel's C entries
    (``model_stencil_layout``, ``model_stencil_limits``,
    ``model_stencil_steps``, ``model_stencil_persistent``), which the main
    library and every generated one export."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    pv, pi = ctypes.POINTER(vp), ctypes.POINTER(ci)
    lib.model_stencil_layout.argtypes = [ci, pi]   # kind, codes
    lib.model_stencil_layout.restype = ci
    lib.model_stencil_limits.argtypes = [pi]
    lib.model_stencil_limits.restype = None
    lib.model_stencil_steps.argtypes = [
        ci, pv, ci,                         # kind, fields, n_fields
        pv, pv,                             # buffer sets 0 and 1
        vp, vp, vp,                         # lft, lft buffers 0 and 1
        vp, vp,                             # weights, in_deg
        pi, pi, ci,                         # dr, dc, n_off
        ci, ci, ci, ci,                     # rows, cols, clock0, n_steps
        pi, vp,                             # launched, stream
    ]
    lib.model_stencil_persistent.argtypes = [
        ci, pv, ci,                         # kind, fields, n_fields
        pv, pv,                             # buffer sets 0 and 1
        vp, vp, vp,                         # lft, lft buffers 0 and 1
        vp, vp,                             # v scratch planes 0 and 1
        vp,                                 # v_pre (nullable; MS_IZH)
        vp, vp,                             # weights, in_deg
        pi, pi, ci,                         # dr, dc, n_off
        ci, ci, ci, ci,                     # rows, cols, clock0, n_steps
        pi, ci, ci,                         # slots, blocks, cap
        pi, vp,                             # launched, stream
    ]
    lib.model_stencil_persistent.restype = ci
    lib.model_stencil_steps.restype = ci


def generated_library_path(text):
    """The library of generated source ``text``: its name holds a hash of
    the text, the headers it may include and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + b"\0"
                            + text.encode())
    for src in HEADERS:
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(GENERATED_DIR,
                        f"libsnn_dsl-{digest.hexdigest()[:16]}.so")


def build_generated(texts):
    """Build each generated source of ``texts`` whose library is not built
    yet: its text written under `GENERATED_DIR`, one nvcc a source (compile
    and link), all started together.  Raises with nvcc's output where a
    build fails.  Returns the libraries' paths, in order."""
    paths = [generated_library_path(t) for t in texts]
    todo = {p: t for p, t in zip(paths, texts) if not os.path.exists(p)}
    if todo:
        with profiling.span("build.compile"):
            _compile_generated(todo)
    return paths


def _compile_generated(todo):
    """nvcc on each generated source of ``todo`` ({library path: text})."""
    global generated_seconds
    os.makedirs(GENERATED_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=GENERATED_DIR) as tmpdir:
        jobs = []
        for path, text in todo.items():
            base = os.path.basename(path)[:-len(".so")]
            src = os.path.join(GENERATED_DIR, base + ".cu")
            tmp_src = os.path.join(tmpdir, base + ".cu")
            with open(tmp_src, "w") as f:
                f.write(text)
            os.replace(tmp_src, src)
            tmp = os.path.join(tmpdir, base + ".so")
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-shared", "-o", tmp, src]
            jobs.append((path, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for path, tmp, cmd, proc in jobs:
            out = proc.communicate()[0]
            generated_logs[os.path.basename(path)] = out
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
            else:
                os.replace(tmp, path)   # atomic, as the main library
        if failed:
            raise RuntimeError("nvcc failed on a generated source:\n"
                               + "\n".join(failed))
    generated_seconds = time.perf_counter() - t0


def load_generated(text):
    """The loaded library of generated source ``text``, built first if
    needed, its model-kernel entries bound."""
    path = build_generated([text])[0]
    lib = _generated.get(path)
    if lib is None:
        lib = ctypes.CDLL(path)
        bind_model_entries(lib)
        _generated[path] = lib
    return lib

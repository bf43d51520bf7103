"""Builds the package's CUDA sources with nvcc and loads them with ctypes.

The library is built at first use, from ``csrc/`` only, into ``_build/``
beside this file: a shared library with a plain C interface for ``sm_90a``
(NVIDIA Hopper).  Its file name carries a hash of the source and flags, so
an edited source is rebuilt and a stale library is never loaded.  Nothing
is built when the package is imported.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -shared -Xcompiler -fPIC -o _build/libizhikevich_stencil-<hash>.so \\
         csrc/izhikevich_stencil.cu

``-fmad=false`` keeps each multiply and add separately rounded, so the
kernel agrees bit for bit with its plain PyTorch twin.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "izhikevich_stencil.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_lib = None
# Set by the build that `load` runs in this process (None when the library
# was already built): wall seconds of the nvcc call and its output, which
# holds ptxas's register and spill report.
build_seconds = None
build_log = ""


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
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libizhikevich_stencil-"
                                   f"{digest.hexdigest()[:16]}.so")


def _compile(out):
    global build_seconds, build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{build_log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def load():
    """The loaded kernel library, built first if needed, with the
    ``argtypes`` and ``restype`` of every exported function set."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not os.path.exists(path):
        _compile(path)
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.izh_stencil_max_offsets.argtypes = []
    lib.izh_stencil_max_offsets.restype = ci
    lib.izh_stencil_steps.argtypes = [
        vp, vp, vp,                         # v, w, lft
        vp, vp, ctypes.POINTER(vp),         # weights, in_deg, params[9]
        vp, vp, vp,                         # buffer set 0
        vp, vp, vp,                         # buffer set 1
        vp, vp,                             # spikes, v_pre (nullable)
        ctypes.POINTER(ci), ctypes.POINTER(ci), ci,   # dr, dc, n_off
        ci, ci, ci, ci,                     # rows, cols, clock0, n_steps
        vp,                                 # stream
    ]
    lib.izh_stencil_steps.restype = ci
    _lib = lib
    return lib

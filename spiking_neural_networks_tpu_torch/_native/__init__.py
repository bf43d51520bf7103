"""ctypes bindings for the host graph-construction library.

PyTorch-package copy of ``spiking_neural_networks_tpu/_native`` with the
same API (`available`, `radius_edges`, `random_edges`, `hopfield_weights`,
`in_degree`, `WEIGHT_MODES`) and the same C++ source.  The first import of
this module builds ``graphlib.cpp`` with g++ (``-O3 -shared -fPIC``) into
``_build/native/graphlib-<hash>.so`` beside the package (gitignored), named
by a hash of the source and the flags, so an edited source is rebuilt and a
stale library is never loaded; importing the package builds nothing.  The
build writes a temporary file and renames it into place, so processes that
build at once (test workers) never load a half-written library.  Without
g++ ``available`` is False and the NumPy paths take over.

The library runs on the host: its outputs are NumPy arrays, which the
callers (`ops.graph.sparse_radius_graph`) move to their device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "graphlib.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build", "native")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

available = False
_lib = None


def library_path():
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0")
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"graphlib-{digest.hexdigest()[:16]}.so")


def _build(so):
    # plain -O3, host-portable: the loops are memory and branch bound
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"
    subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp], check=True,
                   capture_output=True)
    os.replace(tmp, so)


def _load():
    global _lib, available
    try:
        so = library_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
    except Exception:
        available = False
        return

    i64, i32p, f32p, u8p = (ctypes.c_int64,
                            np.ctypeslib.ndpointer(np.int32),
                            np.ctypeslib.ndpointer(np.float32),
                            np.ctypeslib.ndpointer(np.uint8))
    lib.build_radius_edges.restype = ctypes.c_int64
    lib.build_radius_edges.argtypes = [
        i64, i64, ctypes.c_double, ctypes.c_double, ctypes.c_uint64,
        ctypes.c_int32, ctypes.c_double, ctypes.c_double, i32p, i32p, f32p]
    lib.build_random_edges.restype = ctypes.c_int64
    lib.build_random_edges.argtypes = [
        i64, i64, ctypes.c_double, ctypes.c_int32, ctypes.c_uint64,
        ctypes.c_int32, ctypes.c_double, ctypes.c_double, i32p, i32p, f32p,
        i64]
    lib.hopfield_accumulate.restype = None
    lib.hopfield_accumulate.argtypes = [
        u8p, i64, i64, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        f32p]
    lib.in_degree.restype = None
    lib.in_degree.argtypes = [i32p, i64, f32p, i64]
    _lib = lib
    available = True


_load()

# The library's weight modes.  "uniform" draws U[wparam0, wparam1) from the
# edge generator; the NumPy branch of `sparse_radius_graph` calls that mode
# "uniform_random" and treats "uniform" as constant, as the JAX package does.
WEIGHT_MODES = {"constant": 0, "distance": 1, "inv_distance": 2,
                "gaussian": 3, "uniform": 4}


def _need():
    if not available:
        raise RuntimeError("native graphlib unavailable (no g++)")


def radius_edges(rows, cols, radius, keep_prob=1.0, seed=0,
                 weight_mode="constant", wparam0=1.0, wparam1=0.0):
    """COO (src, dst, w) of radius-limited lattice connectivity: src (r +
    dr, c + dc) -> dst (r, c) for every offset within ``radius``, each kept
    with probability ``keep_prob``, no self loops."""
    _need()
    r = int(np.ceil(radius))
    n_off = sum(1 for dr in range(-r, r + 1) for dc in range(-r, r + 1)
                if (dr, dc) != (0, 0) and dr * dr + dc * dc <= radius * radius)
    cap = rows * cols * n_off
    src = np.empty(cap, np.int32)
    dst = np.empty(cap, np.int32)
    w = np.empty(cap, np.float32)
    n = _lib.build_radius_edges(rows, cols, float(radius), float(keep_prob),
                                int(seed), WEIGHT_MODES[weight_mode],
                                float(wparam0), float(wparam1), src, dst, w)
    return src[:n].copy(), dst[:n].copy(), w[:n].copy()


def random_edges(n_pre, n_post, p, exclude_self=True, seed=0,
                 weight_mode="constant", wparam0=1.0, wparam1=0.0):
    """COO (src, dst, w) of Erdos-Renyi connectivity with probability
    ``p`` from ``n_pre`` to ``n_post`` neurons."""
    _need()
    cap = int(n_pre * n_post)
    src = np.empty(cap, np.int32)
    dst = np.empty(cap, np.int32)
    w = np.empty(cap, np.float32)
    n = _lib.build_random_edges(n_pre, n_post, float(p),
                                int(bool(exclude_self)), int(seed),
                                WEIGHT_MODES[weight_mode], float(wparam0),
                                float(wparam1), src, dst, w, cap)
    if n < 0:
        raise RuntimeError("edge capacity exceeded")
    return src[:n].copy(), dst[:n].copy(), w[:n].copy()


def hopfield_weights(patterns, a=0.0, b=0.0, scalar=1.0):
    """Hopfield outer-product weights (n, n) of (P, n) 0/1 patterns."""
    _need()
    pats = np.ascontiguousarray(np.asarray(patterns, np.uint8))
    p, n = pats.shape
    w = np.zeros(n * n, np.float32)
    _lib.hopfield_accumulate(pats.reshape(-1), p, n, float(a), float(b),
                             float(scalar), w)
    return w.reshape(n, n)


def in_degree(dst, n_post):
    """The in-degree of each of ``n_post`` neurons, as float32."""
    _need()
    dst = np.ascontiguousarray(dst, np.int32)
    deg = np.empty(n_post, np.float32)
    _lib.in_degree(dst, len(dst), deg, n_post)
    return deg

"""ctypes binding to the C++ host runtime (native/corrla_host.cpp).

Auto-builds the shared library with g++ on first use if it is missing
(cached next to the source). All entry points degrade gracefully:
``available()`` is False when no compiler/library exists, and the pure-JAX
device paths remain the default everywhere.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libcorrla_host.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO_PATH):
            src = os.path.join(_NATIVE_DIR, "corrla_host.cpp")
            if not os.path.exists(src):
                return None
            try:
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR],
                    check=True, capture_output=True, timeout=300,
                )
            except (subprocess.SubprocessError, OSError):
                return None
        lib = ctypes.CDLL(_SO_PATH)
        lib.cs_dirichlet_rejection.restype = ctypes.c_int64
        lib.cs_dirichlet_rejection.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # bounds
            ctypes.POINTER(ctypes.c_double),  # alphas
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_uint64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),  # out
        ]
        lib.kdtree_build.restype = ctypes.c_void_p
        lib.kdtree_build.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64
        ]
        lib.kdtree_free.argtypes = [ctypes.c_void_p]
        lib.kdtree_knn.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ]
        lib.kendall_tau_knight.restype = ctypes.c_double
        lib.kendall_tau_knight.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
        ]
        lib.demc_dirichlet.restype = ctypes.c_double
        lib.demc_dirichlet.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # bounds
            ctypes.POINTER(ctypes.c_double),  # alphas
            ctypes.c_int64,                   # ndim
            ctypes.POINTER(ctypes.c_double),  # chains (in/out)
            ctypes.c_int64, ctypes.c_int64,   # n_chains, n_steps
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_uint64,                  # seed
            ctypes.POINTER(ctypes.c_double),  # out
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def cs_dirichlet_rejection_host(bounds, n_samples: int, max_zshots: int,
                                chunk_size: int, c_scale: float, alphas,
                                seed: int = 0, n_threads: int = 0) -> np.ndarray:
    """Multithreaded host rejection sampler (streaming, O(1) memory/thread).

    Same contract as ops.samplers.constr_dirichlet_sample; intended for
    pathological acceptance rates where the fixed-chunk device loop wastes
    HBM bandwidth on rejected rows.

    Note: on infeasible bounds this runs the FULL shot budget
    (max_zshots * chunk_size draws split across threads) before raising —
    prefer the device backend for a fast feasibility check, or pass a
    small max_zshots first.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native host runtime unavailable (no g++?)")
    bounds = np.ascontiguousarray(bounds, dtype=np.float64)
    ndim = bounds.shape[0]
    alphas = np.ascontiguousarray(
        np.broadcast_to(np.atleast_1d(np.asarray(alphas, np.float64)), (ndim,))
    )
    out = np.zeros((n_samples, ndim), dtype=np.float64)
    got = lib.cs_dirichlet_rejection(
        _dptr(bounds), _dptr(alphas), ndim, n_samples, max_zshots,
        chunk_size, float(c_scale), int(seed) & (2**64 - 1), n_threads,
        _dptr(out),
    )
    if got < n_samples:
        raise RuntimeError(
            f"host rejection sampler: only {got}/{n_samples} valid samples "
            f"within the shot budget"
        )
    return out


class KdTreeHost:
    """Exact kd-tree kNN on host (parity with the reference's kdtree crate,
    active_subspaces.rs:71-112). Holds a copy of the points."""

    def __init__(self, points):
        lib = _load()
        if lib is None:
            raise RuntimeError("native host runtime unavailable (no g++?)")
        self._lib = lib
        self._pts = np.ascontiguousarray(points, dtype=np.float64)
        self.n, self.d = self._pts.shape
        self._tree = lib.kdtree_build(_dptr(self._pts), self.n, self.d)

    def query(self, queries, k: int, n_threads: int = 0):
        """(dists (m, k), idx (m, k)) sorted ascending."""
        q = np.ascontiguousarray(queries, dtype=np.float64)
        m = q.shape[0]
        assert q.shape[1] == self.d
        out_idx = np.zeros((m, k), dtype=np.int64)
        out_dist = np.zeros((m, k), dtype=np.float64)
        self._lib.kdtree_knn(
            self._tree, _dptr(q), m, k, n_threads,
            out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            _dptr(out_dist),
        )
        return out_dist, out_idx

    def __del__(self):
        try:
            self._lib.kdtree_free(self._tree)
        except Exception:
            pass


def kendall_tau_host(x, y) -> float:
    """Kendall's tau via Knight's O(n log n) merge-sort algorithm (C++).

    Tau-b numerator over the tau-a denominator n(n-1)/2 — identical to the
    device O(n^2) sign-product mean for tie-free data. Use for n beyond
    the ~20k point range where the (n, n) broadcasted device comparison
    stops fitting in HBM.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native host runtime unavailable (no g++?)")
    x = np.ascontiguousarray(x, dtype=np.float64).ravel()
    y = np.ascontiguousarray(y, dtype=np.float64).ravel()
    assert x.shape == y.shape
    return float(lib.kendall_tau_knight(_dptr(x), _dptr(y), x.shape[0]))


def demc_dirichlet_host(bounds, seeds, n_steps: int, gamma: float = 0.8,
                        var_epsilon: float = 1e-12, c_scale: float = 1.0,
                        alphas=0.6, seed: int = 0):
    """Compiled DEMC with a constrained-Dirichlet target (C++ runtime).

    The reference-class competitor for ``cs_mcmc_dirichlet_sample``
    (space_samplers.rs:252-418 + lib_math_utils_py.rs:107-168 semantics:
    parallel-update DEMC generations, simplex-renormalizing fixup,
    Dirichlet+box-prior Metropolis). ``api.cs_mcmc_dirichlet_sample`` runs
    it for populations below ``smallpath.SAMPLER_CHAINS``.

    bounds: (ndim, 2); seeds: (n_chains, ndim) initial chain heads.
    Returns (samples (n_steps * n_chains, ndim) round-robin interleaved
    like the reference's get_samples, accept_ratio).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native host runtime unavailable (no g++?)")
    b = np.ascontiguousarray(bounds, dtype=np.float64)
    chains = np.ascontiguousarray(seeds, dtype=np.float64).copy()
    n_chains, ndim = chains.shape
    assert b.shape == (ndim, 2)
    a = np.ascontiguousarray(
        np.broadcast_to(np.asarray(alphas, np.float64), (ndim,))
    )
    out = np.empty((int(n_steps) * n_chains, ndim), dtype=np.float64)
    ar = lib.demc_dirichlet(
        _dptr(b), _dptr(a), ndim, _dptr(chains), n_chains, int(n_steps),
        float(gamma), float(var_epsilon), float(c_scale), int(seed) or 1,
        _dptr(out),
    )
    return out, float(ar)

"""Small-problem CPU routing, off by default.

Routing commits a small call's inputs to the in-process CPU backend; jax
compiles the identical program for the CPU and every downstream op
follows the committed placement. It was built for an accelerator whose
every dispatch cost tens of milliseconds. On an H100 the GPU is faster at
every size measured (one call, the chip host's 16 CPU cores against the
card; ``examples/measure_gpu_tables.py``):

- ``api.rsvd`` rank 10: 1000x100 5.1 ms GPU vs 10.4 ms CPU; 2000x250
  4.8 vs 24.3 ms; 1000x1000 5.3 vs 25.6 ms;
- ``dream_run`` 3 dims x 500 generations: 64 chains 10.7 ms GPU vs 74 ms
  CPU; 512 chains 12.6 vs 279 ms; 2048 chains 36.6 vs 1231 ms.

So the element threshold defaults to 0 (no routing). ``CORRLA_SMALL_PATH=<n>``
or ``set_small_path_threshold(n)`` routes calls below ``n`` input elements
(samplers: at most ``SAMPLER_CHAINS`` chains) when the default backend is
an accelerator; on CPU-only hosts routing is a no-op. Arrays the caller
explicitly committed to a device are never re-routed.

``SAMPLER_CHAINS`` also bounds the population that
``api.cs_mcmc_dirichlet_sample`` hands to the compiled C++ host pipeline
(``native.demc_dirichlet_host``), which is not JAX routing: 12 chains x
3000 samples take 12 ms there on the chip host.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = [
    "small_path_threshold",
    "set_small_path_threshold",
    "maybe_route_small",
    "route_sampler_small",
    "SAMPLER_CHAINS",
]

_DEFAULT_ELEMS = 0
# population bound for sampler routing (when enabled) and for the C++ host
# pipeline of small cs_mcmc_dirichlet_sample calls
SAMPLER_CHAINS = 512

_threshold = None  # resolved lazily (env override)


def small_path_threshold() -> int:
    """Current element threshold (0 = routing disabled)."""
    global _threshold
    if _threshold is None:
        env = os.environ.get("CORRLA_SMALL_PATH", "")
        if env == "0":
            _threshold = 0
        elif env:
            try:
                _threshold = int(env)
            except ValueError:
                _threshold = _DEFAULT_ELEMS
        else:
            _threshold = _DEFAULT_ELEMS
    return _threshold


def set_small_path_threshold(n_elems: int) -> None:
    """Override the routing threshold (0 disables routing)."""
    global _threshold
    _threshold = int(n_elems)


def _cpu_device():
    import jax

    try:
        return jax.devices("cpu")[0]
    except RuntimeError:
        return None


def _routable(arrays) -> bool:
    import jax

    try:
        if jax.default_backend() == "cpu":
            return False
    except Exception:
        return False
    for a in arrays:
        if isinstance(a, jax.Array) and getattr(a, "committed", False):
            return False  # caller pinned placement explicitly
    return True


def maybe_route_small(*arrays, work_elems: int | None = None):
    """Commit ``arrays`` to the CPU backend when routing is on and the
    problem is below the threshold; otherwise return them unchanged.

    work_elems: explicit work-size proxy (defaults to the total element
    count of ``arrays`` — pass e.g. ``chunk_size * ndim`` when the work
    is bigger than the inputs).
    Returns a tuple matching ``arrays``.
    """
    import jax

    thr = small_path_threshold()
    if thr <= 0 or not _routable(arrays):
        return arrays
    if work_elems is None:
        work_elems = sum(int(np.size(a)) for a in arrays)
    if work_elems >= thr:
        return arrays
    cpu = _cpu_device()
    if cpu is None:
        return arrays
    return tuple(jax.device_put(a, cpu) for a in arrays)


def route_sampler_small(*arrays, n_chains: int,
                        max_chains: int | None = None):
    """Sampler variant: route by population size (when routing is on)."""
    if small_path_threshold() <= 0 or not _routable(arrays):
        return arrays
    lim = SAMPLER_CHAINS if max_chains is None else max_chains
    if n_chains > lim:
        return arrays
    import jax

    cpu = _cpu_device()
    if cpu is None:
        return arrays
    return tuple(jax.device_put(a, cpu) for a in arrays)

"""Profiling / tracing harness.

The reference's only instrumentation is ad-hoc SystemTime deltas in tests
(SURVEY.md §5 "Tracing: none"). Here:

- ``trace(dir)``: context manager around ``jax.profiler.trace`` producing a
  TensorBoard/XProf trace of every XLA kernel.
- ``annotate(name)``: names a region inside a trace
  (``jax.profiler.TraceAnnotation``).
- ``timed(fn)``: best wall-clock of a few runs, each ended by
  ``jax.block_until_ready``.
"""
from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["trace", "annotate", "timed"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region into ``log_dir`` (view with xprof/TensorBoard)."""
    with jax.profiler.trace(log_dir):
        yield


def annotate(name: str):
    """Named sub-region annotation for traces."""
    return jax.profiler.TraceAnnotation(name)


def timed(fn, *args, n_runs: int = 3, **kwargs):
    """(best_wall_seconds, last_result), after one warm-up call."""
    result = jax.block_until_ready(fn(*args, **kwargs))
    best = float("inf")
    for _ in range(n_runs):
        t0 = time.perf_counter()
        result = jax.block_until_ready(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - t0)
    return best, result

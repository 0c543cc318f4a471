"""Debug / NaN-check mode (SURVEY.md §5 commitment).

The reference's only failure handling is panics
(active_subspaces.rs:59, space_samplers.rs:87); silent NaNs flow through
everything else. This module adds an opt-in debug mode:

    import corrla_rs_tpu as crt
    crt.set_debug(True)          # or CORRLA_DEBUG=1 in the environment

When enabled, every public API entry point (api.rsvd/rpca/active_ss/
cs_*_sample) validates its array inputs and outputs for NaN/inf at the
eager boundary and raises ``NonFiniteError`` naming the function and the
offending argument/output — instead of letting poisoned values silently
propagate. The checks synchronize with the device, so leave debug mode
off in production loops.

For *located* in-jit checks, ``checkified(fn)`` wraps a jittable function with
``jax.experimental.checkify`` float checks: the returned callable raises
at the first NaN/inf-producing op with its source location.

Toggling debug clears jax's compilation caches so traced-in guards are
consistent with the flag (the flag is read at trace time in any code
that chooses to branch on it).
"""
from __future__ import annotations

import functools
import os
from typing import Callable

import numpy as np

__all__ = [
    "NonFiniteError", "set_debug", "debug_enabled", "guard_finite",
    "checkified",
]

_DEBUG = bool(int(os.environ.get("CORRLA_DEBUG", "0") or 0))


class NonFiniteError(FloatingPointError):
    """Raised in debug mode when an entry point sees NaN/inf arrays."""


def set_debug(enable: bool = True) -> None:
    """Enable/disable NaN-check debug mode (see module docstring)."""
    global _DEBUG
    enable = bool(enable)
    if enable != _DEBUG:
        _DEBUG = enable
        import jax

        # guards are applied at trace time in jitted code paths; drop any
        # executables traced under the previous flag value
        jax.clear_caches()


def debug_enabled() -> bool:
    return _DEBUG


def _check_tree(tree, fn_name: str, kind: str) -> None:
    import jax

    leaves = jax.tree_util.tree_leaves(tree)
    for i, leaf in enumerate(leaves):
        arr = np.asarray(leaf)
        if arr.dtype.kind not in "fc":
            continue
        if arr.size and not np.isfinite(arr).all():
            n_bad = int((~np.isfinite(arr)).sum())
            raise NonFiniteError(
                f"corrla_rs_tpu debug: {fn_name} {kind} #{i} contains "
                f"{n_bad} non-finite value(s) (shape {arr.shape}, dtype "
                f"{arr.dtype}). Set corrla_rs_tpu.set_debug(False) to "
                "disable this check."
            )


def guard_finite(fn: Callable) -> Callable:
    """Decorator: in debug mode, validate array args and outputs of an
    EAGER entry point (host-side check — works on every backend, including
    runtimes without callbacks). No-op when debug mode is off."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _DEBUG:
            return fn(*args, **kwargs)
        _check_tree([a for a in args if _is_arrayish(a)], fn.__name__,
                    "input")
        out = fn(*args, **kwargs)
        _check_tree(out, fn.__name__, "output")
        return out

    return wrapper


def _is_arrayish(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def checkified(fn: Callable, jit_kwargs: dict | None = None) -> Callable:
    """checkify-wrapped jitted version of ``fn`` with float checks.

    The returned callable raises ``jax.experimental.checkify.JaxRuntimeError``
    at the first NaN/inf-producing op WITH its source location.
    """
    import jax
    from jax.experimental import checkify

    checked = checkify.checkify(fn, errors=checkify.float_checks)
    jitted = jax.jit(checked, **(jit_kwargs or {}))

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        err, out = jitted(*args, **kwargs)
        err.throw()
        return out

    return wrapper

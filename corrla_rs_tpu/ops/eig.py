"""Nonsymmetric (complex) eigendecomposition.

Wherever the reference takes a complex eigendecomposition of a *small*
matrix (DMDc's r x r reduced operator, dmd_rom.rs:112-125), the rebuild
runs the tiny eigensolve on host LAPACK. Two paths:

- ``eig``: the jittable path via ``jax.pure_callback`` — used when the
  backend supports host callbacks AND complex device dtypes (CPU and GPU).
  Probed once per backend at first call (``jittable_eig_supported``). On a
  backend that rejects either, an *eager* call falls back to ``eig_host``;
  a call from inside ``jit`` raises a clear error instead.
- ``eig_host``: eager host LAPACK between jitted stages — works on every
  backend (the operand is fetched to host); returns numpy complex arrays.
  This is what DMDc uses by default (models/dmd.py).

There is also a third, fully on-device path with neither callbacks nor
complex dtypes: ``ops.eig_device`` (real Schur form via an implicit
Francis double-shift QR written in pure JAX, eigenvectors via batched
inverse iteration). It is jit- and vmap-safe on every backend; its outputs
are (re, im) real pairs rather than complex arrays.
``eig_device``/``eigvals_device``/``schur`` are re-exported here.

Symmetric problems (active_subspaces' C = G G^T / N, active_subspaces.rs:260)
do NOT use this: they use ``jnp.linalg.eigh``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.eig_device import (  # noqa: F401  (re-exports)
    eig_device,
    eigvals_device,
    schur,
)

__all__ = [
    "eig", "eig_host", "jittable_eig_supported",
    "eig_device", "eigvals_device", "schur",
]

_JITTABLE_OK: dict[str, bool] = {}


def _host_eig(a):
    vals, vecs = np.linalg.eig(np.asarray(a))
    ctype = np.complex64 if np.asarray(a).dtype == np.float32 else np.complex128
    return vals.astype(ctype), vecs.astype(ctype)


def eig_host(a):
    """Eager host-LAPACK eig; works on every backend.

    Returns (vals (n,), vecs (n, n)) as HOST numpy complex arrays.
    """
    return _host_eig(np.asarray(a))


def jittable_eig_supported(platform: str | None = None) -> bool:
    """Whether this backend can run the pure_callback + complex-dtype path.

    Probes once per platform: a tiny jitted pure_callback returning a
    complex array, forced to host. CPU and GPU pass it. Only the runtime
    errors a backend raises for an unsupported callback or dtype count as
    "unsupported"; any other exception propagates.
    """
    platform = platform or jax.default_backend()
    if platform not in _JITTABLE_OK:
        def _probe(x):
            return np.asarray(x).astype(np.complex64) + 1j

        try:
            out = jax.jit(
                lambda x: jax.pure_callback(
                    _probe,
                    jax.ShapeDtypeStruct((), jnp.complex64),
                    x,
                )
            )(jnp.zeros((), jnp.float32))
            _JITTABLE_OK[platform] = bool(np.isfinite(np.asarray(out)).all())
        except (NotImplementedError, jax.errors.JaxRuntimeError):
            _JITTABLE_OK[platform] = False
    return _JITTABLE_OK[platform]


def _eig_callback(a):
    n = a.shape[-1]
    ctype = jnp.complex64 if a.dtype == jnp.float32 else jnp.complex128
    out_shape = (
        jax.ShapeDtypeStruct(a.shape[:-2] + (n,), ctype),
        jax.ShapeDtypeStruct(a.shape, ctype),
    )
    return jax.pure_callback(_host_eig, out_shape, a, vmap_method="sequential")


def eig(a):
    """Eigenvalues and right eigenvectors of a real square matrix.

    Returns (vals (n,), vecs (n, n)), both complex. On backends where the
    pure_callback + complex-dtype path works this is jit-safe and returns
    device arrays; on backends that reject it an eager call falls back to
    host LAPACK (numpy outputs), and a traced
    call raises with instructions to use ``eig_host`` between jitted
    stages instead.
    """
    if isinstance(a, jax.core.Tracer):
        if not jittable_eig_supported():
            raise NotImplementedError(
                "eig() was traced (called under jit/vmap) but this backend "
                f"({jax.default_backend()}) supports neither host callbacks "
                "nor complex device dtypes. Use eig_device() (fully "
                "on-device, returns (re, im) real pairs — jit/vmap-safe on "
                "every backend), or call eig_host() eagerly between jitted "
                "stages (see models/dmd.py for the pattern)."
            )
        return _eig_callback(a)
    if jittable_eig_supported():
        return _eig_callback(jnp.asarray(a))
    return eig_host(a)

"""Grassmann-manifold interpolation of POD/ROM bases — EXTENSION
(no reference analogue; composes with the reference's POD component,
pod_rom.rs, whose bases this adapts across parameters).

The parametric-ROM workhorse (Amsallem & Farhat 2008): a reduced basis
fitted at one operating point (Mach number, temperature, load, ...) is
wrong at another, but bases at nearby parameters live on the Grassmann
manifold G(n, r) — the set of r-dimensional subspaces of R^n — and can
be interpolated there. Entry-wise interpolation of the basis matrices
is meaningless (a basis is only defined up to right rotation, and the
manifold is curved); interpolation of their LOGARITHMS in the tangent
space at a reference anchor respects both.

Pipeline: ``grassmann_log`` maps each anchor subspace to the tangent
space at a reference anchor; the tangent matrices (fixed-size (n, r)
arrays, rotation-invariant) are interpolated entry-wise over the
parameter coordinates (linear barycentric or any RbfInterp kernel);
``grassmann_exp`` maps the interpolant back to an orthonormal basis.

Accelerator shape: log/exp are two thin SVDs plus matmuls (static shapes,
jit-safe); all p anchor logs run as ONE vmapped SVD batch; tangent
interpolation is one multi-output RBF solve (p x p kernel system,
n*r outputs) — no per-entry loops anywhere.

Conventions: subspaces are represented by orthonormal (n, r) matrices;
all functions treat them as subspace representatives (results are
invariant to right-rotation of the inputs, tested).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.mat_utils import PRECISION

__all__ = ["grassmann_log", "grassmann_exp", "subspace_angles",
           "grassmann_distance", "GrassmannInterp"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


@jax.jit
def grassmann_log(y0: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Tangent vector at span(y0) pointing to span(y) (the log map).

    y0, y : orthonormal (n, r). Returns gamma (n, r) with
    ``grassmann_exp(y0, gamma)`` spanning span(y). Standard closed form:
    L = (Y - Y0 Y0^T Y) (Y0^T Y)^{-1}, thin SVD L = U S V^T,
    gamma = U atan(S) V^T.
    """
    m = _mm(y0.T, y)                            # (r, r)
    # L = (Y - Y0 M) M^{-1}: solve on the right via the transpose system
    resid = y - _mm(y0, m)
    l = jnp.linalg.solve(m.T, resid.T).T        # resid @ inv(M)
    u, s, vt = jnp.linalg.svd(l, full_matrices=False)
    return _mm(u * jnp.arctan(s)[None, :], vt)


@jax.jit
def grassmann_exp(y0: jnp.ndarray, gamma: jnp.ndarray) -> jnp.ndarray:
    """Exponential map: walk from span(y0) along tangent ``gamma``.

    Returns an orthonormal (n, r) basis of the target subspace:
    gamma = U S V^T  ->  Y = Y0 V cos(S) V^T + U sin(S) V^T,
    re-orthonormalized by one QR for float hygiene.
    """
    u, s, vt = jnp.linalg.svd(gamma, full_matrices=False)
    y = (_mm(y0, _mm(vt.T * jnp.cos(s)[None, :], vt))
         + _mm(u * jnp.sin(s)[None, :], vt))
    q, r = jnp.linalg.qr(y)
    # sign-fix so the map is deterministic (QR sign ambiguity)
    return q * jnp.sign(jnp.diagonal(r))[None, :]


@jax.jit
def subspace_angles(y1: jnp.ndarray, y2: jnp.ndarray) -> jnp.ndarray:
    """Principal angles (r,) between span(y1) and span(y2), ascending."""
    s = jnp.linalg.svd(_mm(y1.T, y2), compute_uv=False)
    return jnp.arccos(jnp.clip(s, -1.0, 1.0))[::-1]


@jax.jit
def grassmann_distance(y1: jnp.ndarray, y2: jnp.ndarray) -> jnp.ndarray:
    """Geodesic distance: l2 norm of the principal-angle vector."""
    return jnp.linalg.norm(subspace_angles(y1, y2))


class GrassmannInterp:
    """Interpolate reduced bases over parameters on the Grassmann manifold.

    Parameters
    ----------
    bases : (p, n, r) stack of orthonormal anchor bases.
    params : (p, d) parameter coordinates of the anchors.
    ref : index of the reference anchor whose tangent space hosts the
        interpolation (Amsallem-Farhat pick the anchor nearest the
        query; a central anchor is a good default).
    kernel, kernel_param, poly_degree : RBF interpolant options
        (``ops/interp.RbfInterp``); the default linear kernel +
        poly_degree=1 reproduces multivariate-linear interpolation on
        scattered anchors and is exact at the anchors.

    ``__call__(theta)`` returns the orthonormal (n, r) basis at a new
    parameter point theta (d,).
    """

    def __init__(self, bases, params, ref: int = 0, kernel="linear",
                 kernel_param: float = 1.0, poly_degree: int = 1):
        from corrla_rs_tpu.ops.interp import RbfInterp

        bases = jnp.asarray(bases)
        params = np.atleast_2d(np.asarray(params, dtype=np.float64))
        if params.shape[0] != bases.shape[0]:
            raise ValueError(
                f"{bases.shape[0]} bases but {params.shape[0]} parameter "
                "rows")
        p, n, r = bases.shape
        self.ref = int(ref)
        self.y0 = bases[self.ref]
        # all anchor logs in one vmapped batch (the ref's own log is 0)
        gammas = jax.vmap(grassmann_log, in_axes=(None, 0))(self.y0, bases)
        self._interp = RbfInterp(kernel, kernel_param, params.shape[1],
                                 poly_degree)
        self._interp.fit(params, np.asarray(gammas.reshape(p, n * r)))
        self._shape = (n, r)

    def __call__(self, theta) -> jnp.ndarray:
        theta = np.atleast_2d(np.asarray(theta, dtype=np.float64))
        flat = self._interp.predict(theta)      # (q, n*r)
        n, r = self._shape
        gam = jnp.asarray(flat).reshape(-1, n, r)
        out = jax.vmap(grassmann_exp, in_axes=(None, 0))(self.y0, gam)
        return out[0] if out.shape[0] == 1 else out

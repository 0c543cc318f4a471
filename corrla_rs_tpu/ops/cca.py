"""Canonical correlation analysis — EXTENSION (no reference analogue).

The reference's correlation layer (stats_corr.rs:14-28) stops at the
Pearson matrix of ONE block of variables; CCA is the natural completion
for two blocks: the pairs of directions (a_i, b_i) maximizing
corr(X a_i, Y b_i), mutually uncorrelated across pairs.

Accelerator shape: one pass of (n, p/q) Gram matmuls as dense matmuls, then all
small dense algebra — Cholesky whitening of Sxx/Syy (ridge-regularized)
and one SVD of the (p, q) whitened cross-covariance. Everything jits;
no per-component deflation loop (the SVD gives all pairs at once).

a_i = Lx^{-T} u_i, b_i = Ly^{-T} v_i where Lx = chol(Sxx + reg I) and
M = Lx^{-1} Sxy Ly^{-T} = U diag(rho) V^T.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.linalg import solve_triangular

from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.utils.checkpoint import register_model_class

__all__ = ["Cca", "cca"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


@functools.partial(jax.jit, static_argnames=("n_components",))
def _cca_kernel(x, y, n_components, reg):
    n = x.shape[0]
    xc = x - jnp.mean(x, axis=0, keepdims=True)
    yc = y - jnp.mean(y, axis=0, keepdims=True)
    sxx = _mm(xc.T, xc) / (n - 1)
    syy = _mm(yc.T, yc) / (n - 1)
    sxy = _mm(xc.T, yc) / (n - 1)
    jit_x = (reg + 1e-12) * jnp.trace(sxx) / sxx.shape[0]
    jit_y = (reg + 1e-12) * jnp.trace(syy) / syy.shape[0]
    lx = jnp.linalg.cholesky(sxx + jit_x * jnp.eye(sxx.shape[0], dtype=x.dtype))
    ly = jnp.linalg.cholesky(syy + jit_y * jnp.eye(syy.shape[0], dtype=x.dtype))
    # M = Lx^{-1} Sxy Ly^{-T}
    m = solve_triangular(lx, sxy, lower=True)
    m = solve_triangular(ly, m.T, lower=True).T
    u, rho, vt = jnp.linalg.svd(m, full_matrices=False)
    wx = solve_triangular(lx.T, u[:, :n_components], lower=False)
    wy = solve_triangular(ly.T, vt.T[:, :n_components], lower=False)
    return (rho[:n_components], wx, wy,
            jnp.mean(x, axis=0), jnp.mean(y, axis=0))


@register_model_class
class Cca:
    """Fitted CCA model (see :func:`cca`). Attributes:

    ``corrs`` (k,) canonical correlations (descending, in [0, 1]);
    ``x_weights`` (p, k) / ``y_weights`` (q, k) canonical directions,
    scaled so the training variates have unit variance;
    ``transform(x, y) -> (u, v)`` canonical variates of new data.
    Checkpointable through utils/checkpoint like every other model.
    """

    def transform(self, x=None, y=None):
        """Canonical variates of new rows: returns (u, v); the member
        for a block passed as None is None."""
        u = v = None
        if x is not None:
            u = _mm(jnp.asarray(x) - self.x_mean[None, :], self.x_weights)
        if y is not None:
            v = _mm(jnp.asarray(y) - self.y_mean[None, :], self.y_weights)
        return u, v

    def score(self, x, y) -> np.ndarray:
        """Per-component Pearson correlation of the canonical variates
        on held-out data — the out-of-sample canonical correlations."""
        u, v = self.transform(x, y)
        u = np.asarray(u) - np.asarray(u).mean(axis=0)
        v = np.asarray(v) - np.asarray(v).mean(axis=0)
        num = np.sum(u * v, axis=0)
        den = np.linalg.norm(u, axis=0) * np.linalg.norm(v, axis=0)
        return num / np.where(den > 0, den, 1.0)


def cca(x_data, y_data, n_components: int | None = None,
        reg: float = 0.0) -> Cca:
    """Canonical correlation analysis of two blocks of columns.

    x_data: (n, p), y_data: (n, q) — same rows (observations).
    n_components: number of canonical pairs (default min(p, q)).
    reg: ridge on both block covariances, as a fraction of their mean
    eigenvalue — the regularized CCA of Vinod 1976 (needed when
    p or q approaches n, where plain CCA overfits to corr 1).
    """
    x = jnp.asarray(x_data)
    y = jnp.asarray(y_data)
    if x.ndim != 2 or y.ndim != 2 or x.shape[0] != y.shape[0]:
        raise ValueError(
            f"x, y must be 2-d with equal rows, got {np.shape(x_data)} "
            f"and {np.shape(y_data)}"
        )
    if x.shape[0] < 3:
        raise ValueError(f"need >= 3 rows, got {x.shape[0]}")
    k_max = int(min(x.shape[1], y.shape[1]))
    k = k_max if n_components is None else int(n_components)
    if not 1 <= k <= k_max:
        raise ValueError(
            f"n_components must be in [1, {k_max}], got {n_components}"
        )
    if reg < 0:
        raise ValueError(f"reg must be >= 0, got {reg}")
    rho, wx, wy, mx, my = _cca_kernel(x, y, k, float(reg))
    out = Cca.__new__(Cca)
    out.n_components = k
    out.corrs = np.asarray(rho)
    out.x_weights = wx
    out.y_weights = wy
    out.x_mean = mx
    out.y_mean = my
    return out

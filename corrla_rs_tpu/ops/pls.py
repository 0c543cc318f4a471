"""Partial least squares regression (SIMPLS) — EXTENSION.

The reference's regression layer (stats_corr.rs:96-229) is Vandermonde
OLS — ill-posed for collinear/wide predictor blocks. PLS regresses
through k latent directions chosen to maximize covariance with the
response: the standard tool for p >~ n with correlated columns.

SIMPLS (de Jong 1993) rather than NIPALS: each component is the dominant
left singular vector of the DEFLATED (p, q) cross-covariance S — no
per-component passes over the (n, p) data, so the O(n p) work is two
Gram matmuls as dense matmuls and the component loop is an O(p q k) fori_loop
over small matrices (orthogonal-basis deflation of S). For univariate y
SIMPLS coincides with NIPALS-PLS1 (tested vs sklearn's oracle).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.utils.checkpoint import register_model_class

__all__ = ["PlsRegressor", "pls_fit"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


@functools.partial(jax.jit, static_argnames=("k",))
def _simpls_kernel(x, y, k):
    """SIMPLS on centered data. Returns (coef, x_mean, y_mean,
    x_weights R)."""
    n, p = x.shape
    q = y.shape[1]
    xm = jnp.mean(x, axis=0)
    ym = jnp.mean(y, axis=0)
    xc = x - xm[None, :]
    yc = y - ym[None, :]
    gram = _mm(xc.T, xc)                       # (p, p)
    s0 = _mm(xc.T, yc)                         # (p, q)

    def body(i, carry):
        s, rs, ps, qs, vs = carry
        # dominant left singular vector of s via the (q, q) eigh
        # (q is small; for q=1 this is s itself normalized)
        sts = _mm(s.T, s)
        _, evecs = jnp.linalg.eigh(sts)
        c = evecs[:, -1]                        # (q,)
        r = _mm(s, c[:, None])[:, 0]            # (p,)
        r = r / jnp.maximum(jnp.linalg.norm(r), 1e-300)
        gr = _mm(gram, r[:, None])[:, 0]        # X^T X r
        tt = jnp.maximum(r @ gr, 1e-300)        # ||t||^2 = r^T X^T X r
        p_load = gr / tt                        # (p,) loading
        q_load = _mm(s.T, r[:, None])[:, 0] / tt
        # orthonormal basis of the loading span; deflate S against it
        v = p_load
        v = v - _mm(vs, _mm(vs.T, v[:, None]))[:, 0]
        v = v / jnp.maximum(jnp.linalg.norm(v), 1e-300)
        s = s - _mm(v[:, None], _mm(v[None, :], s))
        rs = rs.at[:, i].set(r)
        ps = ps.at[:, i].set(p_load)
        qs = qs.at[:, i].set(q_load)
        vs = vs.at[:, i].set(v)
        return s, rs, ps, qs, vs

    z_p = jnp.zeros((p, k), x.dtype)
    z_q = jnp.zeros((q, k), x.dtype)
    _, rs, ps, qs, _ = lax.fori_loop(
        0, k, body, (s0, z_p, z_p, z_q, z_p)
    )
    coef = _mm(rs, qs.T)                        # (p, q)
    return coef, xm, ym, rs


@register_model_class
class PlsRegressor:
    """Fitted SIMPLS model (see :func:`pls_fit`). ``coef`` (p, q) maps
    centered predictors to centered responses; ``x_weights`` (p, k) are
    the latent directions (X scores = Xc @ x_weights)."""

    def predict(self, x_new) -> jnp.ndarray:
        """(m, q) predicted responses for (m, p) new rows."""
        xn = jnp.asarray(x_new)
        return _mm(xn - self.x_mean[None, :], self.coef) + self.y_mean[None, :]

    def transform(self, x_new) -> jnp.ndarray:
        """(m, k) latent scores of new rows."""
        xn = jnp.asarray(x_new)
        return _mm(xn - self.x_mean[None, :], self.x_weights)

    def score(self, x_new, y_new) -> float:
        """R^2 of ``predict`` on held-out data (uniform average over
        response columns, sklearn convention)."""
        y = np.asarray(y_new, np.float64)
        if y.ndim == 1:
            y = y[:, None]
        pred = np.asarray(self.predict(x_new), np.float64)
        ss_res = np.sum((y - pred) ** 2, axis=0)
        ss_tot = np.sum((y - y.mean(axis=0)) ** 2, axis=0)
        return float(np.mean(1.0 - ss_res / np.where(ss_tot > 0, ss_tot, 1.0)))


def pls_fit(x_data, y_data, n_components: int) -> PlsRegressor:
    """Fit a SIMPLS partial-least-squares regression.

    x_data: (n, p) predictors, y_data: (n,) or (n, q) responses.
    n_components: number of latent components (1 <= k <= min(n-1, p)).
    """
    x = jnp.asarray(x_data)
    y = jnp.asarray(y_data)
    if y.ndim == 1:
        y = y[:, None]
    if x.ndim != 2 or y.ndim != 2 or x.shape[0] != y.shape[0]:
        raise ValueError(
            f"x, y must be 2-d with equal rows, got {np.shape(x_data)} "
            f"and {np.shape(y_data)}"
        )
    k_max = int(min(x.shape[0] - 1, x.shape[1]))
    k = int(n_components)
    if not 1 <= k <= k_max:
        raise ValueError(
            f"n_components must be in [1, {k_max}], got {n_components}"
        )
    coef, xm, ym, rs = _simpls_kernel(x, y, k)
    out = PlsRegressor.__new__(PlsRegressor)
    out.n_components = k
    out.coef = coef
    out.x_mean = xm
    out.y_mean = ym
    out.x_weights = rs
    return out

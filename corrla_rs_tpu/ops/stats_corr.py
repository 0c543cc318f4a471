"""Correlation / covariance / polynomial-regression layer.

Parity with reference stats_corr.rs:14-249. All routines are pure jnp
expressions that jit into dense matmuls; the local polynomial fits are
vmap-able (used batched by active_subspaces).

Deviations (recorded per SURVEY.md §2.4):
- ``sample_mv_normal`` uses the Cholesky factor by default — the reference
  computes ``cov @ z`` (stats_corr.rs:46-58), giving samples with covariance
  C @ C^T instead of C. ``mode='reference'`` reproduces the quirk for parity
  testing.
- ``jac_from_quad`` differentiates the fitted quadratic analytically
  (exactly) instead of the reference's eps=1e-10 forward difference
  (stats_corr.rs:230-249).
- The stray debug ``print!`` in ``rsquared_sens`` (stats_corr.rs:90-93) is
  not reproduced.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from corrla_rs_tpu.ops.mat_utils import (
    PRECISION,
    center_mat_col,
    pinv,
    zcenter_mat_col,
)
from corrla_rs_tpu.utils.prng import as_key

__all__ = [
    "pearson_corr",
    "mat_cov_centered",
    "sample_mv_normal",
    "sandwich_prop",
    "rsquared_sens",
    "mat_col_interactions",
    "linear_fit",
    "jac_from_lin",
    "mat_col_powers",
    "build_vandermonde",
    "build_full_vandermonde",
    "quad_fit",
    "quad_eval",
    "jac_from_quad",
]


def pearson_corr(x: jnp.ndarray) -> jnp.ndarray:
    """Linear correlation matrix between columns. stats_corr.rs:14-28."""
    xz = zcenter_mat_col(x)
    n = x.shape[0]
    return jnp.matmul(xz.T, xz, precision=PRECISION) / (n - 1.0)


def mat_cov_centered(x: jnp.ndarray) -> jnp.ndarray:
    """Sample covariance of columns. stats_corr.rs:32-43."""
    xc = center_mat_col(x)
    n = x.shape[0]
    return jnp.matmul(xc.T, xc, precision=PRECISION) / (n - 1.0)


def sample_mv_normal(cov, n: int, key=0, mode: str = "cholesky") -> jnp.ndarray:
    """Draw n samples from N(0, cov) -> (n, d).

    mode='cholesky' (default): correct MVN sampling via chol(cov) @ z.
    mode='reference': the reference computes ``cov @ z`` (stats_corr.rs:46-58)
    so samples have covariance cov @ cov^T — kept only for parity tests.
    """
    cov = jnp.asarray(cov)
    z = jax.random.normal(as_key(key), (n, cov.shape[0]), dtype=cov.dtype)
    if mode == "reference":
        return jnp.matmul(z, cov.T, precision=PRECISION)
    chol = jnp.linalg.cholesky(cov)
    return jnp.matmul(z, chol.T, precision=PRECISION)


def sandwich_prop(cov: jnp.ndarray, jac: jnp.ndarray) -> jnp.ndarray:
    """Sandwich covariance propagation J C J^T. stats_corr.rs:64-68."""
    return jnp.matmul(jnp.matmul(jac, cov, precision=PRECISION), jac.T,
                      precision=PRECISION)


def rsquared_sens(x: jnp.ndarray, y: jnp.ndarray, cor_dof: bool = False) -> jnp.ndarray:
    """R^2 sensitivity R^2 = r_y^T R_xx^+ r_y, optional DoF correction.

    Parity with stats_corr.rs:75-107 (Bostelmann et al., Ann. Nucl. Energy
    165, 2022). Returns a (1, 1) matrix like the reference.
    """
    n, k = x.shape
    xy = jnp.concatenate([x, y], axis=1)
    r_xy = pearson_corr(xy)
    r_xx = r_xy[:-1, :-1]
    r_y = r_xy[:-1, -1:]
    r_sqr = jnp.matmul(
        jnp.matmul(r_y.T, pinv(r_xx), precision=PRECISION), r_y,
        precision=PRECISION,
    )
    if cor_dof:
        dof_factor = (n - 1.0) / (n - k - 1.0)
        r_sqr = 1.0 - (1.0 - r_sqr) * dof_factor
    return r_sqr


def _interaction_indices(k: int, include_self: bool):
    idx = []
    for ia in range(k):
        for ib in range(ia, k):
            if ia == ib and not include_self:
                continue
            idx.append((ia, ib))
    return idx


def mat_col_interactions(x: jnp.ndarray, include_self_interactions: bool) -> jnp.ndarray:
    """Columns of pairwise products x_a * x_b (upper triangle order).

    Parity with stats_corr.rs:112-142 — same column ordering:
    x1x1, x1x2, ..., x1xN, x2x2, ..., xNxN.
    """
    k = x.shape[1]
    pairs = _interaction_indices(k, include_self_interactions)
    ia = jnp.array([p[0] for p in pairs])
    ib = jnp.array([p[1] for p in pairs])
    return x[:, ia] * x[:, ib]


def linear_fit(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Least-squares hyperplane fit via Vandermonde pinv. stats_corr.rs:146-160.

    Returns (k+1, y_cols): slopes then intercept.
    """
    vand = jnp.concatenate([x, jnp.ones((x.shape[0], 1), x.dtype)], axis=1)
    return jnp.matmul(pinv(vand), y, precision=PRECISION)


def jac_from_lin(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Partial derivatives dy/dx_i from a linear fit. stats_corr.rs:164-169.

    Returns (y_cols, k) — typically (1, k).
    """
    coeffs = linear_fit(x, y)
    return coeffs[: x.shape[1], :].T


def mat_col_powers(x: jnp.ndarray, max_degree: int) -> jnp.ndarray:
    """hstack of x, x^2, ..., x^max_degree. stats_corr.rs:173-180."""
    return jnp.concatenate(
        [x] + [x**d for d in range(2, max_degree + 1)], axis=1
    )


def build_vandermonde(x: jnp.ndarray, include_self_interactions: bool) -> jnp.ndarray:
    """[x | interactions(x) | 1]. stats_corr.rs:201-209."""
    inter = mat_col_interactions(x, include_self_interactions)
    ones = jnp.ones((x.shape[0], 1), x.dtype)
    return jnp.concatenate([x, inter, ones], axis=1)


def build_full_vandermonde(x: jnp.ndarray, degree: int) -> jnp.ndarray:
    """Vandermonde used by RBF poly augmentation. stats_corr.rs:183-198.

    degree < 2: [x | 1]; degree >= 2: quadratic with self interactions
    (the reference never recurses beyond quadratic; see the commented-out
    loop at stats_corr.rs:193-195).
    """
    if degree < 2:
        return jnp.concatenate([x, jnp.ones((x.shape[0], 1), x.dtype)], axis=1)
    return build_vandermonde(x, True)


def quad_fit(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Fit a full quadratic in k dims. stats_corr.rs:213-219."""
    vand = build_vandermonde(x, True)
    return jnp.matmul(pinv(vand), y, precision=PRECISION)


def quad_eval(x: jnp.ndarray, coeffs: jnp.ndarray) -> jnp.ndarray:
    """Evaluate the fitted quadratic. stats_corr.rs:222-226."""
    return jnp.matmul(build_vandermonde(x, True), coeffs, precision=PRECISION)


def jac_from_quad(x0: jnp.ndarray, coeffs: jnp.ndarray) -> jnp.ndarray:
    """Gradient of the fitted quadratic at each row of x0.

    Exact analytic jacobian of ``quad_eval`` (the reference uses eps=1e-10
    forward differencing, stats_corr.rs:230-249; exact differentiation is a
    strict improvement with identical semantics for quadratics).
    Returns (n_points, k).
    """
    def scalar_eval(row):
        return quad_eval(row[None, :], coeffs)[0, 0]

    return jax.vmap(jax.grad(scalar_eval))(x0)

"""Interpolative and CUR (skeleton) decompositions — EXTENSION.

Low-rank factorizations whose factors are actual rows/columns of A:

    column ID :  A ~= A[:, J] @ X          X (k, n), X[:, J] = I_k
    row ID    :  A ~= Z @ A[I, :]          Z (m, k), Z[I, :] = I_k
    CUR       :  A ~= A[:, J] @ U @ A[I, :]

Unlike the SVD's abstract singular vectors, the skeleton columns/rows ARE
data: representative snapshots, sensor locations, landmark points. This
is the column-space counterpart of DEIM (ops/deim.py selects rows of a
given mode basis; here both the basis and the selection come from A
itself) and rounds out the randomized-decomposition family the reference
builds around random_svd.rs (the reference has no ID/CUR).

Algorithm (Liberty et al. 2007 / Voronin & Martinsson 2017): compress A
to B = Q^T A (l, n) with the randomized range finder already used by
random_svd (ops/random_svd.power_iter, parity random_svd.rs:15-59),
then run greedy column-pivoted QR on the small B to pick the k pivot
columns and form the interpolation matrix X = R11^{-1} R by one
triangular solve.

Accelerator shape: the QRCP is a ``lax.fori_loop`` over k rank-1
Gram-Schmidt downdates of the (l, n) panel — static shapes, one dynamic
column gather per step, everything jitted; the heavy lifting (sketch,
B = Q^T A) is dense matmuls. Selection quality therefore matches QRCP on
the l-dimensional compression of A, the standard randomized-ID choice.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.ops.random_svd import power_iter
from corrla_rs_tpu.utils.prng import as_key

__all__ = ["column_id", "row_id", "cur"]


@functools.partial(jax.jit, static_argnames=("k",))
def _qrcp(b: jnp.ndarray, k: int):
    """Greedy column-pivoted QR of ``b`` (l, n): k pivots + R (k, n).

    Step j picks the column of the residual panel with the largest norm,
    normalizes it into q_j, and rank-1-downdates the panel. R rows are
    q_j^T applied to the pre-downdate panel, so R[:, pivots] is upper
    triangular (residuals of already-chosen columns are exactly the
    downdated zeros). Selected columns are masked out of the argmax so
    fp dust never re-selects one.
    """
    l, n = b.shape
    dtype = b.dtype
    tiny = jnp.asarray(jnp.finfo(dtype).tiny ** 0.5, dtype)

    def body(j, state):
        w, r, piv, sel = state
        norms = jnp.sum(w * w, axis=0)
        norms = jnp.where(sel, -1.0, norms)
        p = jnp.argmax(norms).astype(jnp.int32)
        col = lax.dynamic_index_in_dim(w.T, p, axis=0, keepdims=False)
        q = col / jnp.maximum(jnp.linalg.norm(col), tiny)
        rrow = jnp.matmul(q, w, precision=PRECISION)
        w = w - q[:, None] * rrow[None, :]
        return (
            w,
            r.at[j].set(rrow),
            piv.at[j].set(p),
            sel.at[p].set(True),
        )

    state = (
        b,
        jnp.zeros((k, n), dtype),
        jnp.zeros((k,), jnp.int32),
        jnp.zeros((n,), bool),
    )
    _, r, piv, _ = lax.fori_loop(0, k, body, state)
    return piv, r


def _interp_from_r(r: jnp.ndarray, piv: jnp.ndarray) -> jnp.ndarray:
    """X = R11^{-1} R with R11 = R[:, piv] (upper triangular by
    construction). Tiny diagonals (rank < k requested) are clamped to
    eps * max|diag| so the solve stays finite — the corresponding
    interpolation rows are then ~arbitrary but bounded, matching LAPACK
    xGEQP3-based ID behavior past the numerical rank."""
    k = r.shape[0]
    r11 = jnp.take(r, piv, axis=1)
    d = jnp.diagonal(r11)
    eps = jnp.finfo(r.dtype).eps
    floor = eps * jnp.maximum(jnp.max(jnp.abs(d)), 1.0)
    d_safe = jnp.where(jnp.abs(d) < floor, floor, d)
    r11 = r11 - jnp.diag(d) + jnp.diag(d_safe)
    x = jax.scipy.linalg.solve_triangular(r11, r, lower=False)
    # exactness at the skeleton: X[:, piv] = I by construction up to the
    # solve's rounding; pin it
    return x.at[:, piv].set(jnp.eye(k, dtype=r.dtype))


def column_id(a, rank: int, n_iter: int = 2, n_oversamples: int = 8,
              key=0):
    """Randomized column interpolative decomposition.

    Returns ``(cols (rank,) int32, x (rank, n))`` with
    ``a ~= a[:, cols] @ x`` and ``x[:, cols] == I``. Error tracks the
    rank-``rank`` SVD error times a modest pivoting factor.

    Parameters mirror ``random_svd``: ``n_iter`` power iterations sharpen
    the range estimate (0 = plain one-sketch ID), ``n_oversamples`` pads
    the sketch. ``a`` may be wider or taller than square; dtype is
    preserved.
    """
    a = jnp.asarray(a)
    m, n = a.shape
    if not 1 <= rank <= min(m, n):
        raise ValueError(
            f"rank must be in [1, min(m, n)] = [1, {min(m, n)}], "
            f"got {rank}"
        )
    l = min(rank + int(n_oversamples), min(m, n))
    q = power_iter(a, l, int(n_iter), key=as_key(key))
    b = jnp.matmul(q.T, a, precision=PRECISION)     # (l, n) compression
    piv, r = _qrcp(b, rank)
    return piv, _interp_from_r(r, piv)


def row_id(a, rank: int, n_iter: int = 2, n_oversamples: int = 8, key=0):
    """Randomized row interpolative decomposition.

    Returns ``(rows (rank,) int32, z (m, rank))`` with
    ``a ~= z @ a[rows, :]`` and ``z[rows, :] == I`` — the transpose of
    :func:`column_id`.
    """
    piv, x = column_id(jnp.asarray(a).T, rank, n_iter=n_iter,
                       n_oversamples=n_oversamples, key=key)
    return piv, x.T


def cur(a, rank: int, n_iter: int = 2, n_oversamples: int = 8, key=0,
        method: str = "stable"):
    """Randomized CUR: ``a ~= a[:, cols] @ u @ a[rows, :]``.

    Returns ``(rows (rank,), cols (rank,), u (rank, rank))``. Rows and
    columns are selected by independent row/column IDs (fresh subkeys);
    ``method`` picks how U is formed:

    - ``'stable'`` (default): U = C^+ A R^+ via two least-squares solves
      — the optimal core for the chosen skeletons, robust to noise
      (Mahoney & Drineas 2009 semantics).
    - ``'skeleton'``: U = A[rows, cols]^{-1} (classical cross /
      Goreinov skeleton) — exact when rank(A) = rank and the
      intersection block is nonsingular, cheapest, but noise in the
      k x k block propagates unchecked.
    """
    if method not in ("stable", "skeleton"):
        raise ValueError(
            f"method must be 'stable' or 'skeleton', got {method!r}"
        )
    a = jnp.asarray(a)
    k_col, k_row = jax.random.split(as_key(key))
    cols, _ = column_id(a, rank, n_iter=n_iter,
                        n_oversamples=n_oversamples, key=k_col)
    rows, _ = row_id(a, rank, n_iter=n_iter,
                     n_oversamples=n_oversamples, key=k_row)
    c = jnp.take(a, cols, axis=1)
    r = jnp.take(a, rows, axis=0)
    if method == "skeleton":
        w = jnp.take(c, rows, axis=0)
        u = jnp.linalg.solve(
            w, jnp.eye(rank, dtype=a.dtype)
        )
    else:
        # U = pinv(C) A pinv(R) without forming pinvs: two lstsq solves
        # (normal-equation-free, backward stable on device)
        ca, _, _, _ = jnp.linalg.lstsq(c, a)        # (k, n) = C^+ A
        u, _, _, _ = jnp.linalg.lstsq(r.T, ca.T)    # (k, k)^T = (C^+A) R^+
        u = u.T
    return rows, cols, u

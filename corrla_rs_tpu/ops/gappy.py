"""Gappy POD: field reconstruction from sparse point sensors, and
iterative repair of gappy snapshot data — EXTENSION (no reference
analogue; composes with the reference's POD component, pod_rom.rs, and
this library's DEIM sensor selection).

Two classical capabilities (Everson & Sirovich 1995; Bui-Thanh,
Damodaran & Willcox 2004):

1. **Sensor reconstruction** (``gappy_reconstruct``): given r POD modes
   U (n, r) and measurements of a field at s >= r known locations,
   recover the full field as ``x_hat = U c`` with
   ``c = argmin_c || x_obs - U_obs c ||^2`` — the oversampled (s > r)
   generalization of DEIM interpolation (``ops/deim`` is the exact
   s == r case). Oversampling trades sensors for noise robustness:
   the error amplification is ||pinv(U_obs)||, which shrinks as rows
   are added.
2. **Gappy-data repair** (``gappy_pod_fill``): given a snapshot matrix
   with missing entries (a mask), alternate [POD of the current fill ->
   re-estimate missing entries from the gappy projection] until the
   fill converges. This is subspace-iteration repair, complementary to
   ``ops/completion.matrix_complete`` (factor-ALS): gappy POD adapts
   the basis to the data each sweep and returns the basis, ALS
   optimizes fixed-rank factors directly.

Accelerator shape: sensor rows are one static-shape gather; the LS solve
is an s x r lstsq via QR (or a ridge-regularized r x r Gram solve —
both static); multiple snapshots are one batched matmul, NOT a vmapped
loop. The repair sweep is a ``lax.scan`` whose body is
[masked fill -> r-truncated SVD -> project -> re-fill] — static shapes
throughout, jits end-to-end on any backend.

Sensor placement for s > r: ``oversample_points`` extends DEIM greedily
by the row that minimizes the reconstruction-operator amplification
(greedy minimization of ||pinv(U_obs)||_F^2 via rank-one updates of
(U_obs^T U_obs)^{-1} — Peherstorfer/Drmac-style oversampling), as a
``lax.fori_loop`` over candidate rows.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from corrla_rs_tpu.ops.mat_utils import PRECISION

__all__ = ["gappy_reconstruct", "gappy_pod_fill", "oversample_points"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


@functools.partial(jax.jit, static_argnames=("ridge",))
def gappy_reconstruct(modes: jnp.ndarray, points: jnp.ndarray,
                      values: jnp.ndarray, ridge: float = 0.0):
    """Reconstruct full fields from values at ``points`` rows.

    Parameters
    ----------
    modes : (n, r) POD/DMD mode matrix (columns span the field space).
    points : (s,) int row indices of the sensors, s >= r.
    values : (s,) or (s, m) measured field values at those rows
        (columns are independent snapshots).
    ridge : optional Tikhonov weight on the coefficient norm; use > 0
        when sensors are noisy or nearly collinear.

    Returns ``(x_hat, coeffs)``: the reconstructed field(s) (n,)/(n, m)
    and the generalized (gappy) POD coefficients (r,)/(r, m).
    ``x_hat`` is exact for any field in span(modes) when ridge == 0 and
    U_obs has full column rank.
    """
    u_obs = modes[points]                       # (s, r) static gather
    vec = values.ndim == 1
    b = values[:, None] if vec else values      # (s, m)
    if ridge > 0.0:
        r = modes.shape[1]
        g = _mm(u_obs.T, u_obs) + ridge * jnp.eye(r, dtype=modes.dtype)
        coeffs = jnp.linalg.solve(g, _mm(u_obs.T, b))
    else:
        # QR-based lstsq: stable for oversampled sensor sets without
        # squaring the condition number
        q, rr = jnp.linalg.qr(u_obs)
        coeffs = jax.scipy.linalg.solve_triangular(rr, _mm(q.T, b))
    x_hat = _mm(modes, coeffs)
    if vec:
        return x_hat[:, 0], coeffs[:, 0]
    return x_hat, coeffs


@functools.partial(jax.jit, static_argnames=("rank", "n_sweeps"))
def gappy_pod_fill(snapshots: jnp.ndarray, mask: jnp.ndarray,
                   rank: int, n_sweeps: int = 25):
    """Repair a gappy snapshot matrix by iterated gappy-POD projection.

    Parameters
    ----------
    snapshots : (n, m) data matrix; entries where ``mask`` is False are
        ignored (their values never enter the result).
    mask : (n, m) bool, True = observed.
    rank : POD rank used for the repair subspace.
    n_sweeps : fixed sweep count (lax.scan; convergence is typically
        geometric once the subspace locks in).

    Returns ``(filled, modes, sigma)``: the repaired matrix (observed
    entries kept verbatim), the final (n, rank) POD modes of the
    repaired data, and their singular values.
    """
    mask_f = mask.astype(snapshots.dtype)
    x_obs = jnp.where(mask, snapshots, 0.0)
    # init: fill missing entries with the per-row observed mean (a row
    # with nothing observed falls back to 0)
    cnt = jnp.maximum(mask_f.sum(axis=1, keepdims=True), 1.0)
    row_mean = x_obs.sum(axis=1, keepdims=True) / cnt
    x0 = jnp.where(mask, snapshots, jnp.broadcast_to(row_mean,
                                                     snapshots.shape))

    def sweep(x, _):
        u, s, _vt = jnp.linalg.svd(x, full_matrices=False)
        ur = u[:, :rank]                        # (n, r)
        # per-snapshot gappy LS in the CURRENT basis: for column j solve
        # min_c || M_j (x_j - U c) ||^2  ->  (U^T M_j U) c = U^T M_j x_j.
        # Batched: Grams (m, r, r) via einsum, one batched solve.
        g = jnp.einsum("ik,ij,il->jkl", ur, mask_f, ur)
        g = g + 1e-10 * jnp.eye(rank, dtype=x.dtype)
        rhs = jnp.einsum("ik,ij->jk", ur, x_obs)
        c = jnp.linalg.solve(g, rhs[..., None])[..., 0]     # (m, r)
        x_new = jnp.where(mask, snapshots, _mm(ur, c.T))
        return x_new, s[:rank]

    filled, sig_hist = lax.scan(sweep, x0, None, length=n_sweeps)
    u, s, _vt = jnp.linalg.svd(filled, full_matrices=False)
    del sig_hist
    return filled, u[:, :rank], s[:rank]


@functools.partial(jax.jit, static_argnames=("n_extra",))
def oversample_points(modes: jnp.ndarray, points: jnp.ndarray,
                      n_extra: int):
    """Greedily append ``n_extra`` sensor rows to an existing selection.

    Starting from ``points`` (e.g. the r DEIM points), each step adds
    the row u that maximizes the smallest eigenvalue-proxy
    det-gain 1 + u^T (U_s^T U_s)^{-1} u of the sensor Gram — i.e. the
    row whose inclusion most reduces the pseudo-inverse amplification
    (rank-one Sherman-Morrison update, no re-factorization). Rows
    already selected are excluded via masking.

    Returns the extended (len(points) + n_extra,) int32 index vector.
    """
    n, r = modes.shape
    s0 = points.shape[0]
    total = s0 + int(n_extra)
    dtype = modes.dtype

    sel = jnp.full((total,), -1, jnp.int32).at[:s0].set(
        points.astype(jnp.int32))
    u0 = modes[points]                          # (s0, r)
    g = _mm(u0.T, u0) + 1e-12 * jnp.eye(r, dtype=dtype)
    ginv = jnp.linalg.inv(g)
    taken = jnp.zeros((n,), bool).at[points].set(True)

    def body(j, state):
        sel, ginv, taken = state
        # gain_i = u_i^T G^{-1} u_i; adding the largest-gain row gives
        # the biggest log-det increase of the sensor Gram
        gu = _mm(modes, ginv)                   # (n, r)
        gain = jnp.sum(gu * modes, axis=1)
        gain = jnp.where(taken, -jnp.inf, gain)
        p = jnp.argmax(gain).astype(jnp.int32)
        u = modes[p]
        gu_p = _mm(ginv, u[:, None])            # (r, 1)
        denom = 1.0 + jnp.dot(u, gu_p[:, 0])
        ginv = ginv - _mm(gu_p, gu_p.T) / denom
        return (sel.at[j].set(p), ginv, taken.at[p].set(True))

    sel, _, _ = lax.fori_loop(s0, total, body, (sel, ginv, taken))
    return sel

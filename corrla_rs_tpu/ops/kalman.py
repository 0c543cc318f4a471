"""Steady-state Kalman filtering for identified LTI models — EXTENSION
(no reference analogue).

Closes the loop on the system-identification chain (okid -> era): a
realization (A, B, C, D) predicts from a KNOWN state, but operating
data only gives inputs/outputs — the Kalman filter supplies the state
estimate, the innovations sequence (the model-validation residual:
white iff the model + noise covariances are right), and the innovations
log-likelihood (the evidence for comparing identified orders/noise
levels).

Accelerator shape: the steady-state filter covariance solves the DARE by
a fixed-iteration Riccati recursion under lax.scan (static shapes, no
data-dependent control flow; convergence is linear with ratio
|lambda_max(A-KCA)|^2 so ~200 iterations is far past f64 for any
reasonably damped system), and the filter itself is ONE lax.scan whose
per-step work is r x r matvecs. Everything jits end-to-end.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.mat_utils import PRECISION

__all__ = ["dare", "kalman_filter", "kalman_smooth", "dlqr"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


@functools.partial(jax.jit, static_argnames=("n_iters",))
def _dare_kernel(a, c, q, r, n_iters):
    def step(p, _):
        cp = _mm(c, p)                          # (q, n)
        s = _mm(cp, c.T) + r                    # innovation covariance
        k = jnp.linalg.solve(s, cp).T           # P C^T S^{-1}  (n, q)
        p_upd = p - _mm(k, cp)                  # measurement update
        p_new = _mm(_mm(a, p_upd), a.T) + q     # time update
        p_new = 0.5 * (p_new + p_new.T)
        return p_new, jnp.float32(0)

    p0 = q + jnp.eye(a.shape[0], dtype=a.dtype)
    p, _ = jax.lax.scan(step, p0, None, length=n_iters)
    return p


def dare(a, c, q, r, n_iters: int = 200):
    """Steady-state PREDICTED-state error covariance P of the Kalman
    filter for x' = A x + w (cov Q), y = C x + v (cov R): the
    stabilizing solution of the filter DARE

      P = A (P - P C^T (C P C^T + R)^{-1} C P) A^T + Q

    by fixed-iteration Riccati recursion (matches
    scipy.linalg.solve_discrete_are(a.T, c.T, q, r) — tested)."""
    a = jnp.asarray(a)
    c = jnp.atleast_2d(jnp.asarray(c))
    q = jnp.asarray(q)
    r = jnp.atleast_2d(jnp.asarray(r))
    n = a.shape[0]
    if a.shape != (n, n) or q.shape != (n, n) or c.shape[1] != n \
            or r.shape != (c.shape[0], c.shape[0]):
        raise ValueError(
            f"shape mismatch: a {a.shape}, c {c.shape}, q {q.shape}, "
            f"r {r.shape}"
        )
    return _dare_kernel(a, c, q, r, int(n_iters))


def dlqr(a, b, q, r, n_iters: int = 200):
    """Discrete-time infinite-horizon LQR for x' = A x + B u with cost
    sum x^T Q x + u^T R u: returns (k_gain, p) with u = -K x and P the
    stabilizing solution of the CONTROL DARE

      P = A^T (P - P B (B^T P B + R)^{-1} B^T P) A + Q.

    By filter/control duality this is :func:`dare` on the transposed
    system (A -> A^T, C -> B^T), so the same fixed-iteration Riccati
    kernel serves both; K = (B^T P B + R)^{-1} B^T P A. Closes the
    identification chain: era_okid -> kalman_filter -> dlqr is
    identify -> estimate -> control.
    """
    a = jnp.asarray(a)
    n = int(a.shape[0])
    b = jnp.asarray(b)
    if b.ndim == 1:
        b = b[:, None]
    # validate with CONTROL-side names (errors surfacing from dare()
    # would talk about 'c' on the transposed system) and broadcast
    # scalar costs like kalman_filter broadcasts scalar covariances
    if b.shape[0] != n:
        raise ValueError(f"b must be ({n}, n_u), got {b.shape}")
    n_u = int(b.shape[1])
    q_mat = (float(q) * jnp.eye(n, dtype=a.dtype)
             if np.ndim(q) == 0 else jnp.asarray(q))
    r_mat = (float(r) * jnp.eye(n_u, dtype=a.dtype)
             if np.ndim(r) == 0 else jnp.atleast_2d(jnp.asarray(r)))
    if q_mat.shape != (n, n) or r_mat.shape != (n_u, n_u):
        raise ValueError(
            f"q must be ({n}, {n}) and r ({n_u}, {n_u}), got "
            f"{q_mat.shape} / {r_mat.shape}"
        )
    p = dare(a.T, b.T, q_mat, r_mat, n_iters=n_iters)
    s = _mm(_mm(b.T, p), b) + r_mat
    k_gain = jnp.linalg.solve(s, _mm(_mm(b.T, p), a))
    return k_gain, p


@jax.jit
def _kf_kernel(a, b, c, d, k, x0, u, y):
    """Predictor-form steady-state filter: carries the PREDICTED state
    x̂_t|t-1; per step e_t = y_t - C x̂ - D u_t, filtered state
    x̂_t|t = x̂ + K e_t, next prediction x̂' = A x̂_t|t + B u_t."""
    def step(xh, uy):
        u_t, y_t = uy
        e = y_t - _mm(c, xh[:, None])[:, 0] - _mm(d, u_t[:, None])[:, 0]
        x_filt = xh + _mm(k, e[:, None])[:, 0]
        xh_next = _mm(a, x_filt[:, None])[:, 0] \
            + _mm(b, u_t[:, None])[:, 0]
        return xh_next, (x_filt, e)

    _, (xs, es) = jax.lax.scan(step, x0, (u.T, y.T))
    return xs.T, es.T


def kalman_filter(a, b, c, d, q, r, u_seq, y_seq, x0=None,
                  n_dare_iters: int = 200, _with_mats: bool = False):
    """Steady-state Kalman filter over an input-output record.

    a/b/c/d: the realization (e.g. ``fit.a`` ... from :func:`era_okid`;
    pass ``d=None`` for no feedthrough); q/r: process / measurement
    noise covariances (scalars broadcast to sigma^2 I); u_seq (n_u, T),
    y_seq (n_y, T); x0: initial predicted state (default 0).

    Returns a dict: ``x_filt`` (n, T) filtered states, ``innovations``
    (n_y, T), ``gain`` (n, n_y) the steady-state Kalman gain,
    ``innovation_cov`` (n_y, n_y) = C P C^T + R, and ``loglik`` — the
    Gaussian innovations log-likelihood (the model-evidence number for
    comparing identified models / noise levels).
    """
    a = jnp.asarray(a)
    n = int(a.shape[0])
    b = jnp.asarray(b)
    if b.ndim == 1:
        b = b[:, None]
    if b.shape[0] != n:
        # explicit check: a silent reshape would row-major SCRAMBLE a
        # transposed B into a wrong-but-plausible model
        raise ValueError(f"b must be ({n}, n_u), got {b.shape}")
    c = jnp.atleast_2d(jnp.asarray(c))
    p_out = int(c.shape[0])
    if d is None:
        d_mat = jnp.zeros((p_out, b.shape[1]), a.dtype)
    else:
        d_mat = jnp.atleast_2d(jnp.asarray(d))
        if d_mat.shape != (p_out, int(b.shape[1])):
            raise ValueError(
                f"d must be ({p_out}, {int(b.shape[1])}), got "
                f"{d_mat.shape}"
            )
    q_mat = (float(q) * jnp.eye(n, dtype=a.dtype)
             if np.ndim(q) == 0 else jnp.asarray(q))
    r_mat = (float(r) * jnp.eye(p_out, dtype=a.dtype)
             if np.ndim(r) == 0 else jnp.atleast_2d(jnp.asarray(r)))
    u = jnp.asarray(u_seq)
    y = jnp.asarray(y_seq)
    if u.ndim == 1:
        u = u[None, :]
    if y.ndim == 1:
        y = y[None, :]
    if u.shape[0] != b.shape[1] or y.shape[0] != p_out \
            or u.shape[1] != y.shape[1]:
        raise ValueError(
            f"u_seq/y_seq must be ({b.shape[1]}, T)/({p_out}, T), got "
            f"{u.shape} / {y.shape}"
        )
    x0 = (jnp.zeros((n,), a.dtype) if x0 is None
          else jnp.asarray(x0).reshape(n))

    p = dare(a, c, q_mat, r_mat, n_iters=n_dare_iters)
    s = _mm(_mm(c, p), c.T) + r_mat
    k = jnp.linalg.solve(s, _mm(c, p)).T          # P C^T S^{-1}
    x_filt, innov = _kf_kernel(a, b, c, d_mat, k, x0, u, y)
    # Gaussian innovations log-likelihood with constant steady-state S
    t_len = int(u.shape[1])
    sign, logdet = jnp.linalg.slogdet(s)
    quad = jnp.sum(innov * jnp.linalg.solve(s, innov))
    loglik = -0.5 * (t_len * (p_out * jnp.log(2 * jnp.pi) + logdet)
                     + quad)
    out = {"x_filt": x_filt, "innovations": innov, "gain": k,
           "innovation_cov": s, "loglik": float(loglik),
           "state_cov": p}
    if _with_mats:   # internal: the RTS smoother reuses these
        return out, (a, b, c, p, k, u)
    return out


@jax.jit
def _rts_kernel(a, b, g, x_filt, u):
    """Backward Rauch-Tung-Striebel pass with the steady-state smoother
    gain G = P_f A^T P^{-1}: x_s[t] = x_f[t] + G (x_s[t+1] - x_p[t+1]),
    x_p[t+1] = A x_f[t] + B u[t]."""
    x_pred_next = _mm(a, x_filt) + _mm(b, u)      # (n, T): x_p[t+1]

    def step(x_s_next, cols):
        xf, xp_next = cols
        x_s = xf + _mm(g, (x_s_next - xp_next)[:, None])[:, 0]
        return x_s, x_s

    last = x_filt[:, -1]
    _, xs_rev = jax.lax.scan(
        step, last,
        (x_filt.T[:-1][::-1], x_pred_next.T[:-1][::-1]),
    )
    return jnp.concatenate([xs_rev[::-1].T, last[:, None]], axis=1)


def kalman_smooth(a, b, c, d, q, r, u_seq, y_seq, x0=None,
                  n_dare_iters: int = 200):
    """Fixed-interval RTS smoother on top of :func:`kalman_filter`
    (steady-state gains). Returns the filter's dict plus ``x_smooth``
    (n, T) — each state estimated from the WHOLE record, so smoothed
    error is never worse than filtered (tested)."""
    out, (a_m, b_m, c_m, p, k, u) = kalman_filter(
        a, b, c, d, q, r, u_seq, y_seq, x0=x0,
        n_dare_iters=n_dare_iters, _with_mats=True,
    )
    # filtered covariance P_f = (I - K C) P; smoother gain P_f A^T P^-1
    p_f = p - _mm(k, _mm(c_m, p))
    g = jnp.linalg.solve(p.T, _mm(a_m, p_f.T)).T   # P_f A^T P^{-1}
    out["x_smooth"] = _rts_kernel(a_m, b_m, g, out["x_filt"], u)
    return out

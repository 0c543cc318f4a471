"""Sequential Monte Carlo filtering (bootstrap particle filter) and the
unscented Kalman filter — EXTENSION (no reference analogue; completes
the state-estimation family: ops/kalman = linear-Gaussian, ops/enkf =
ensemble, here = sigma-point and fully non-Gaussian).

Why both: the UKF is the cheap deterministic option when the posterior
stays near-Gaussian (2n+1 sigma points, no sampling noise, exact on
linear systems — tested against ops/kalman at f64 identity tolerance);
the particle filter is the asymptotically exact option for multimodal /
heavy-tailed posteriors and — crucially — returns an UNBIASED estimate
of the marginal likelihood p(y_{1:T}) (Del Moral 2004), the
model-evidence number that turns a state-space model into something
you can compare and calibrate (particle MCMC uses exactly this).

Accelerator shape: both filters are ONE lax.scan over time with static
shapes. The particle step is vmapped propagation + a weight logsumexp
+ systematic resampling expressed as searchsorted gather (no
data-dependent control flow: resampling is computed every step and
SELECTED by the adaptive-ESS predicate with jnp.where, so the compiled
program is branch-free). The UKF step is Cholesky + three small
matmuls on the sigma-point batch.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.mat_utils import PRECISION

__all__ = ["particle_filter", "ukf_filter"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


def _systematic_indices(key, log_w, n):
    """Systematic resampling indices from normalized log-weights
    (shared shape with ops/smc's resampler; kept local so each module
    jits self-contained)."""
    w = jnp.exp(log_w - jax.scipy.special.logsumexp(log_w))
    cdf = jnp.cumsum(w)
    u = jax.random.uniform(key, (), w.dtype)
    pos = (u + jnp.arange(n, dtype=w.dtype)) / n
    return jnp.clip(jnp.searchsorted(cdf, pos), 0, n - 1)


def particle_filter(x0_particles, y_seq, propagate, loglik_obs, key,
                    resample_threshold: float = 0.5, mesh=None,
                    axis_name=None):
    """Bootstrap (SIR) particle filter with adaptive systematic
    resampling.

    x0_particles (N, n): draws from the initial state distribution;
    y_seq (T, p) observations; propagate(key, x) -> x': the STOCHASTIC
    transition for one particle (vmapped; fold process noise in here);
    loglik_obs(x, y) -> scalar log p(y | x) per particle (vmapped);
    resample_threshold: resample when ESS < threshold * N (1.0 =
    always, 0.0 = never).

    Multi-chip: ``mesh=`` particle-shards the cloud over ``axis_name``
    (first mesh axis by default; the axis size must divide N). Per
    step, propagation and observation likelihoods run shard-local; the
    evidence/ESS reductions are psum'd scalars and only the systematic
    resample gathers the (N,) weight vector plus the selected particle
    rows across the mesh (the SURVEY §2.2 chain-head contract — GSPMD
    inserts the collectives from the sharding annotation). Same keys as
    the single-device path, so results agree to reduction-order
    tolerance.

    Returns a dict: ``means`` (T, n) posterior-weighted filtered
    means, ``loglik`` — the log marginal likelihood estimate
    log p(y_{1:T}) (unbiased in expectation of the likelihood;
    the particle-MCMC / model-comparison number), ``ess`` (T,)
    effective sample size per step, ``particles`` / ``log_weights``
    — the final posterior cloud.
    """
    x0 = jnp.asarray(x0_particles)
    if x0.ndim != 2:
        raise ValueError(f"x0_particles must be (N, n), got {x0.shape}")
    n_part = int(x0.shape[0])
    y_seq = jnp.asarray(y_seq)
    if y_seq.ndim == 1:
        y_seq = y_seq[:, None]
    if not 0.0 <= float(resample_threshold) <= 1.0:
        raise ValueError("resample_threshold must be in [0, 1]")
    thresh = float(resample_threshold) * n_part
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        ax = axis_name or mesh.axis_names[0]
        if n_part % mesh.shape[ax]:
            raise ValueError(
                f"mesh axis size ({mesh.shape[ax]}) must divide the "
                f"particle count ({n_part})")
        x0 = jax.device_put(x0, NamedSharding(mesh, P(ax, None)))
    else:
        from corrla_rs_tpu.utils.smallpath import maybe_route_small
        x0, y_seq = maybe_route_small(
            x0, y_seq,
            work_elems=int(y_seq.shape[0]) * int(np.prod(x0.shape)))
    prop_v = jax.vmap(propagate, in_axes=(0, 0))
    lik_v = jax.vmap(loglik_obs, in_axes=(0, None))
    log_n = jnp.log(jnp.asarray(float(n_part), x0.dtype))

    def step(carry, y_t):
        parts, log_w, k, ll = carry
        k, k_prop, k_res = jax.random.split(k, 3)
        parts = prop_v(jax.random.split(k_prop, n_part), parts)
        lw_obs = lik_v(parts, y_t)
        lw_new = log_w + lw_obs
        # evidence increment: log sum_i w_i p(y|x_i) with normalized w
        inc = jax.scipy.special.logsumexp(lw_new)
        log_w = lw_new - inc
        ess = 1.0 / jnp.sum(jnp.exp(2.0 * log_w))
        w = jnp.exp(log_w)
        mean = _mm(w[None, :], parts)[0]
        # branch-free adaptive resampling: compute indices every step,
        # select by the ESS predicate
        idx = _systematic_indices(k_res, log_w, n_part)
        take = ess < thresh
        idx = jnp.where(take, idx, jnp.arange(n_part))
        parts = parts[idx]
        log_w = jnp.where(take, jnp.full_like(log_w, -log_n), log_w)
        return (parts, log_w, k, ll + inc), (mean, ess)

    init = (x0, jnp.full((n_part,), -log_n, x0.dtype), key,
            jnp.zeros((), x0.dtype))
    (parts, log_w, _, ll), (means, ess) = jax.lax.scan(
        step, init, y_seq)
    return {"means": means, "loglik": float(ll), "ess": ess,
            "particles": parts, "log_weights": log_w}


def _ut_weights(n, alpha, beta, kappa, dtype):
    lam = alpha**2 * (n + kappa) - n
    c = n + lam
    wm = jnp.full((2 * n + 1,), 1.0 / (2.0 * c), dtype)
    wm = wm.at[0].set(lam / c)
    wc = wm.at[0].set(lam / c + (1.0 - alpha**2 + beta))
    return wm, wc, c


def ukf_filter(x0_mean, x0_cov, y_seq, f, h, q, r,
               alpha: float = 1.0, beta: float = 2.0,
               kappa: float = 0.0, jitter: float = 0.0):
    """Unscented Kalman filter (Julier-Uhlmann sigma points, Wan-van
    der Merwe scaling) over an observation record.

    x0_mean (n,) / x0_cov (n, n): initial state belief; y_seq (T, p);
    f(x) -> x' the DETERMINISTIC transition (process noise enters as
    additive covariance q); h(x) -> y the observation map; q / r:
    process / observation noise covariances (scalars broadcast);
    alpha/beta/kappa: the standard UT scaling knobs (default alpha=1:
    the textbook 1e-3..1e-1 values make the UT weights huge-and-
    cancelling (w0 = -99 at alpha=0.1, n=2), which costs ~4 digits in
    f32; shrink alpha only in f64); jitter: added to
    the predicted covariance diagonal before each Cholesky (set ~1e-9
    for stiff f32 problems).

    Exact on linear systems — means, covariances AND the innovations
    log-likelihood reproduce the closed-form Kalman filter (tested at
    1e-9). Returns a dict: ``means`` (T, n), ``covs`` (T, n, n)
    filtered moments, ``loglik`` the Gaussian innovations
    log-likelihood (the model-evidence surrogate for near-Gaussian
    posteriors — compare with :func:`particle_filter`'s exact one).
    """
    x0_mean = jnp.asarray(x0_mean).reshape(-1)
    n = int(x0_mean.shape[0])
    x0_cov = jnp.asarray(x0_cov)
    if np.ndim(x0_cov) == 0:
        x0_cov = float(x0_cov) * jnp.eye(n, dtype=x0_mean.dtype)
    if x0_cov.shape != (n, n):
        raise ValueError(f"x0_cov must be ({n}, {n}), got {x0_cov.shape}")
    y_seq = jnp.asarray(y_seq)
    if y_seq.ndim == 1:
        y_seq = y_seq[:, None]
    p = int(y_seq.shape[1])
    dt = x0_mean.dtype
    q_mat = (float(q) * jnp.eye(n, dtype=dt) if np.ndim(q) == 0
             else jnp.asarray(q, dt))
    r_mat = (float(r) * jnp.eye(p, dtype=dt) if np.ndim(r) == 0
             else jnp.atleast_2d(jnp.asarray(r, dt)))
    if np.ndim(q) == 1:
        q_mat = jnp.diag(jnp.asarray(q, dt))
    if np.ndim(r) == 1:
        r_mat = jnp.diag(jnp.asarray(r, dt))
    if q_mat.shape != (n, n) or r_mat.shape != (p, p):
        raise ValueError(
            f"q must be ({n}, {n}) and r ({p}, {p}), got "
            f"{q_mat.shape} / {r_mat.shape}"
        )
    from corrla_rs_tpu.utils.smallpath import maybe_route_small
    x0_mean, x0_cov, y_seq, q_mat, r_mat = maybe_route_small(
        x0_mean, x0_cov, y_seq, q_mat, r_mat,
        work_elems=int(y_seq.shape[0]) * (2 * n + 1) * n * n)
    wm, wc, c = _ut_weights(n, float(alpha), float(beta),
                            float(kappa), dt)
    sqrt_c = jnp.sqrt(jnp.asarray(c, dt))
    f_v = jax.vmap(f)
    h_v = jax.vmap(h)
    jit_eye = float(jitter) * jnp.eye(n, dtype=dt)
    log2pi = jnp.log(2.0 * jnp.asarray(np.pi, dt))

    def sigma_points(mean, cov):
        chol = jnp.linalg.cholesky(0.5 * (cov + cov.T) + jit_eye)
        offs = sqrt_c * chol.T                      # rows: scaled cols of L
        return jnp.concatenate(
            [mean[None, :], mean + offs, mean - offs], axis=0)

    # all moment sums below are BROADCASTED multiply+reduce, not
    # matmuls: the contraction dim is 2n+1 (tiny), and an elementwise
    # sum keeps full f32 whatever the backend's matmul precision
    def _wsum(w, rows):
        return jnp.sum(w[:, None] * rows, axis=0)

    def _wgram(w, da, db):
        return jnp.sum(w[:, None, None] * da[:, :, None]
                       * db[:, None, :], axis=0)

    def step(carry, y_t):
        mean, cov, ll = carry
        # --- predict ---
        sp = sigma_points(mean, cov)                # (2n+1, n)
        sp_f = f_v(sp)
        m_pred = _wsum(wm, sp_f)
        d_f = sp_f - m_pred
        p_pred = _wgram(wc, d_f, d_f) + q_mat
        # --- update (fresh sigma points from the prediction) ---
        sp2 = sigma_points(m_pred, p_pred)
        sp_h = h_v(sp2)
        y_pred = _wsum(wm, sp_h)
        d_y = sp_h - y_pred
        d_x = sp2 - m_pred
        s = _wgram(wc, d_y, d_y) + r_mat            # innovation cov
        c_xy = _wgram(wc, d_x, d_y)                 # cross cov
        gain = jnp.linalg.solve(s.T, c_xy.T).T      # C_xy S^{-1}
        innov = y_t - y_pred
        mean_new = m_pred + jnp.sum(gain * innov[None, :], axis=1)
        g_s = jnp.sum(gain[:, :, None] * s[None, :, :], axis=1)
        cov_new = p_pred - jnp.sum(
            g_s[:, None, :] * gain[None, :, :], axis=2)
        cov_new = 0.5 * (cov_new + cov_new.T)
        sign, logdet = jnp.linalg.slogdet(s)
        # f32 PD breakdown of the innovation covariance must surface as
        # NaN in loglik, not a silently wrong value
        logdet = jnp.where(sign > 0, logdet, jnp.nan)
        quad = jnp.sum(innov * jnp.linalg.solve(s, innov))
        ll = ll - 0.5 * (p * log2pi + logdet + quad)
        return (mean_new, cov_new, ll), (mean_new, cov_new)

    (_, _, ll), (means, covs) = jax.lax.scan(
        step, (x0_mean, x0_cov, jnp.zeros((), dt)), y_seq)
    return {"means": means, "covs": covs, "loglik": float(ll)}

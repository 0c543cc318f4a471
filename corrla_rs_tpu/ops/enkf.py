"""Ensemble data assimilation: EnKF, ETKF, and ES-MDA — EXTENSION
(no reference analogue; completes the state-estimation family next to
the linear-Gaussian filter in ops/kalman.py).

The linear Kalman filter (ops/kalman) needs the model as explicit
(A, B, C) matrices and propagates a full n x n covariance. Ensemble
methods need only a black-box forward map and carry the covariance
IMPLICITLY in an ensemble of N states — the workhorse for nonlinear /
high-dimensional assimilation (weather, reservoir history matching)
and for Bayesian calibration of expensive simulators (ES-MDA).

Accelerator shape: the ensemble is a (N, n) matrix, so propagation is one
vmapped batch and every analysis is dense linear algebra. Both analyses
work in ENSEMBLE space — all O(N^2) Grams and an N x N eigh — so cost
is O(N^2 (n + p)) and the n x n covariance is never formed:

- stochastic EnKF (Burgers/Evensen 1998): perturbed observations,
  centered so the analysis mean is unbiased; gain solve in whichever of
  obs space (p x p) / ensemble space (N x N, Woodbury) is smaller.
- ETKF (Bishop 2001, in Hunt 2007's ensemble-space form): a
  deterministic square-root filter — exact mean update and exact
  posterior SAMPLE covariance (I - KH) P_b with zero sampling noise
  from perturbations (both properties tested against the closed-form
  Kalman update built from the same sample covariances).
- ES-MDA (Emerick & Reynolds 2013): n_mda tempered EnKF updates with
  inflated observation noise alpha_i R, sum(1/alpha_i) = 1 — the
  ensemble analogue of the tempered-likelihood ladder in ops/smc.

`enkf_filter` runs the full forecast/analysis cycle as ONE lax.scan
(static shapes; multiplicative inflation; stochastic or deterministic
analysis), so a whole assimilation window jits end-to-end.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.mat_utils import PRECISION

__all__ = ["enkf_analysis", "etkf_analysis", "enkf_filter", "esmda"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


def _member_shard(x_ens, mesh, axis_name):
    """Member-shard the (N, n) ensemble over the mesh (SURVEY §2.2: the
    ensemble axis is this family's tall axis). All analyses are built
    from ensemble Grams (Ya^T Ya, Ya^T Xa) whose contraction runs over
    the sharded member axis, so GSPMD inserts psums of the O(p*(p+n))
    Gram blocks — the sharded-RSVD contract — and the (N, n) ensemble
    itself never crosses a chip boundary (HLO-guarded in
    tests/test_sharded_factorizations.py)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    ax = axis_name or mesh.axis_names[0]
    n_dev = mesh.shape[ax]
    if x_ens.shape[0] % n_dev:
        raise ValueError(
            f"mesh axis size ({n_dev}) must divide the ensemble size "
            f"({x_ens.shape[0]})")
    return jax.device_put(x_ens, NamedSharding(mesh, P(ax, None)))


def _as_r_matrix(r, p, dtype):
    """Broadcast scalar / vector / matrix observation covariance to
    (p, p); returns (r_mat, r_diag_or_None) so diagonal R keeps its
    cheap inverse."""
    if np.ndim(r) == 0:
        d = jnp.full((p,), float(r), dtype)
        return jnp.diag(d), d
    r = jnp.asarray(r, dtype)
    if r.ndim == 1:
        if r.shape[0] != p:
            raise ValueError(f"diagonal r must have length {p}, got "
                             f"{r.shape}")
        return jnp.diag(r), r
    if r.shape != (p, p):
        raise ValueError(f"r must be ({p}, {p}), got {r.shape}")
    return r, None


def _obs_ensemble(x_ens, h):
    """Apply the observation operator: (p, n) matrix or per-member
    callable x (n,) -> (p,), vmapped over the ensemble."""
    if callable(h):
        return jax.vmap(h)(x_ens)
    h = jnp.asarray(h)
    return _mm(x_ens, h.T)


@jax.jit
def _enkf_kernel_obs_space(x_ens, y_ens, d_pert, r_mat):
    """Perturbed-obs update with the (p, p) solve: good when p <= N."""
    n_ens = x_ens.shape[0]
    xa = x_ens - jnp.mean(x_ens, axis=0)                  # (N, n)
    ya = y_ens - jnp.mean(y_ens, axis=0)                  # (N, p)
    c_yy = _mm(ya.T, ya) / (n_ens - 1) + r_mat            # (p, p)
    # X_a = X + (D - Y) C_yy^{-1} C_yx, with C_yx = Ya^T Xa/(N-1)
    w = jnp.linalg.solve(c_yy, _mm(ya.T, xa) / (n_ens - 1))   # (p, n)
    return x_ens + _mm(d_pert - y_ens, w)


@jax.jit
def _enkf_kernel_ens_space(x_ens, y_ens, d_pert, r_inv_diag):
    """Perturbed-obs update via Woodbury in ensemble space (N x N
    solve): good when p >> N and R is diagonal.

    (S S^T/(N-1) + R)^{-1} = R^-1 - R^-1 S ((N-1)I + S^T R^-1 S)^{-1}
    S^T R^-1  with S = Ya^T (p, N)."""
    n_ens = x_ens.shape[0]
    xa = x_ens - jnp.mean(x_ens, axis=0)
    ya = y_ens - jnp.mean(y_ens, axis=0)                  # (N, p)
    resid = d_pert - y_ens                                # (N, p)
    yr = ya * r_inv_diag                                  # Ya R^-1
    inner = (n_ens - 1) * jnp.eye(n_ens, dtype=x_ens.dtype) \
        + _mm(yr, ya.T)                                   # (N, N)
    t1 = resid * r_inv_diag                               # resid R^-1
    t2 = _mm(t1, ya.T)                                    # (N, N)
    t3 = jnp.linalg.solve(inner.T, t2.T).T                # (N, N)
    coeff = t1 - _mm(t3, yr)               # (N, p): resid C_yy^{-1}
    # X + resid C_yy^{-1} C_yx, with C_yx = Ya^T Xa / (N-1)
    return x_ens + _mm(_mm(coeff, ya.T), xa) / (n_ens - 1)


def enkf_analysis(x_ens, y_obs, h, r, key, inflation: float = 1.0,
                  mesh=None, axis_name=None):
    """Stochastic (perturbed-observation) EnKF analysis step.

    x_ens (N, n) forecast ensemble; y_obs (p,) observation; h the
    observation operator — a (p, n) matrix or a callable x -> y
    (vmapped over members); r the observation-noise covariance (scalar
    / diagonal vector / full matrix); key drives the observation
    perturbations (CENTERED, so the analysis mean is unbiased);
    inflation multiplies forecast anomalies before the update.

    Returns the analysis ensemble (N, n). Ensemble-space Woodbury is
    used automatically when p > N and R is diagonal, so megapixel
    observation vectors never trigger a (p, p) solve.

    Multi-chip: ``mesh=`` member-shards the ensemble; the update's
    member-axis Gram contractions psum O(p*(p+n)) blocks and the
    perturbed-obs draw is key-identical to the single-device run, so
    the sharded analysis matches at reduction-order (f64 ~1e-12)
    tolerance. The mesh axis size must divide N.
    """
    x_ens = jnp.asarray(x_ens)
    if x_ens.ndim != 2:
        raise ValueError(f"x_ens must be (N, n), got {x_ens.shape}")
    n_ens = int(x_ens.shape[0])
    if n_ens < 2:
        raise ValueError("need at least 2 ensemble members")
    if mesh is not None:
        x_ens = _member_shard(x_ens, mesh, axis_name)
    y_obs = jnp.asarray(y_obs).reshape(-1)
    p = int(y_obs.shape[0])
    r_mat, r_diag = _as_r_matrix(r, p, x_ens.dtype)
    if inflation != 1.0:
        mean = jnp.mean(x_ens, axis=0)
        x_ens = mean + inflation * (x_ens - mean)
    y_ens = _obs_ensemble(x_ens, h)
    if y_ens.shape != (n_ens, p):
        raise ValueError(
            f"observation operator produced {y_ens.shape}, expected "
            f"({n_ens}, {p})"
        )
    # centered perturbations: exact zero-mean noise so the ENSEMBLE
    # MEAN sees the unperturbed innovation
    if r_diag is not None:
        eps = jnp.sqrt(r_diag) * jax.random.normal(
            key, (n_ens, p), x_ens.dtype)
    else:
        chol = jnp.linalg.cholesky(r_mat)
        eps = _mm(jax.random.normal(key, (n_ens, p), x_ens.dtype),
                  chol.T)
    eps = eps - jnp.mean(eps, axis=0)
    d_pert = y_obs + eps
    if r_diag is not None and p > n_ens:
        return _enkf_kernel_ens_space(x_ens, y_ens, d_pert,
                                      1.0 / r_diag)
    return _enkf_kernel_obs_space(x_ens, y_ens, d_pert, r_mat)


@jax.jit
def _etkf_kernel(x_ens, y_ens, y_obs, r_inv_diag):
    """Hunt 2007 ensemble-space square-root update (diagonal R)."""
    n_ens = x_ens.shape[0]
    xbar = jnp.mean(x_ens, axis=0)
    xa = x_ens - xbar                                     # (N, n)
    ybar = jnp.mean(y_ens, axis=0)
    ya = y_ens - ybar                                     # (N, p)
    d = y_obs - ybar                                      # (p,)
    c = ya * r_inv_diag                                   # Ya R^-1 (N, p)
    inner = (n_ens - 1) * jnp.eye(n_ens, dtype=x_ens.dtype) \
        + _mm(c, ya.T)                                    # (N, N)
    evals, evecs = jnp.linalg.eigh(inner)
    evals = jnp.maximum(evals, jnp.finfo(x_ens.dtype).tiny)
    # Pa~ = inner^{-1};  W = sqrt((N-1) Pa~)  (symmetric sqrt)
    pa_half = _mm(evecs * jax.lax.rsqrt(evals),
                  evecs.T) * jnp.sqrt(jnp.asarray(n_ens - 1,
                                                  x_ens.dtype))
    wbar = _mm(evecs * (1.0 / evals),
               _mm(evecs.T, _mm(c, d[:, None])))[:, 0]    # (N,)
    w_full = wbar + pa_half                               # rows: per-member weights
    return xbar + _mm(w_full, xa)


def etkf_analysis(x_ens, y_obs, h, r, inflation: float = 1.0,
                  mesh=None, axis_name=None):
    """Deterministic ensemble-transform Kalman filter analysis.

    Same signature as :func:`enkf_analysis` minus the key (no
    perturbations — it is a square-root filter). Requires diagonal R
    (scalar or vector); full R is whitened by its Cholesky factor
    first. Properties (tested): the analysis MEAN equals the exact
    Kalman update built from the sample covariances, and the analysis
    SAMPLE covariance equals (I - KH) P_b exactly — no Monte-Carlo
    noise, which is why ETKF dominates stochastic EnKF at small N.

    Multi-chip: ``mesh=`` member-shards the ensemble. The N x N
    transform (eigh of the ensemble-space inner matrix) is replicated —
    it is O(N^2) data, small by construction — while the O(N*n) state
    block stays sharded; collectives move O(N*(N+p)) blocks, never the
    ensemble.
    """
    x_ens = jnp.asarray(x_ens)
    if x_ens.ndim != 2:
        raise ValueError(f"x_ens must be (N, n), got {x_ens.shape}")
    n_ens = int(x_ens.shape[0])
    if n_ens < 2:
        raise ValueError("need at least 2 ensemble members")
    if mesh is not None:
        x_ens = _member_shard(x_ens, mesh, axis_name)
    y_obs = jnp.asarray(y_obs).reshape(-1)
    p = int(y_obs.shape[0])
    r_mat, r_diag = _as_r_matrix(r, p, x_ens.dtype)
    if inflation != 1.0:
        mean = jnp.mean(x_ens, axis=0)
        x_ens = mean + inflation * (x_ens - mean)
    y_ens = _obs_ensemble(x_ens, h)
    if y_ens.shape != (n_ens, p):
        raise ValueError(
            f"observation operator produced {y_ens.shape}, expected "
            f"({n_ens}, {p})"
        )
    if r_diag is None:
        # whiten full R: solve L z = y so the whitened problem has
        # identity noise covariance
        chol = jnp.linalg.cholesky(r_mat)
        y_ens = jax.scipy.linalg.solve_triangular(
            chol, y_ens.T, lower=True).T
        y_obs = jax.scipy.linalg.solve_triangular(
            chol, y_obs[:, None], lower=True)[:, 0]
        r_inv_diag = jnp.ones((p,), x_ens.dtype)
    else:
        r_inv_diag = 1.0 / r_diag
    return _etkf_kernel(x_ens, y_ens, y_obs, r_inv_diag)


def enkf_filter(x0_ens, y_seq, propagate, h, r, key,
                method: str = "etkf", inflation: float = 1.0,
                q=None, mesh=None, axis_name=None):
    """Full forecast/analysis assimilation cycle as one lax.scan.

    x0_ens (N, n) initial ensemble; y_seq (T, p) observations;
    propagate: per-member state map x (n,) -> (n,) (vmapped; must be
    jax-traceable); h / r as in :func:`enkf_analysis`; q: optional
    additive process-noise covariance (scalar / diagonal vector) —
    sampled fresh each forecast; method 'etkf' (deterministic,
    default) or 'stochastic'.

    Returns a dict: ``means`` (T, n) analysis means, ``ensemble``
    (N, n) final analysis ensemble, ``spread`` (T,) mean analysis
    std — the filter-health diagnostic (collapse => inflate).

    Multi-chip: ``mesh=`` member-shards the ensemble for the WHOLE
    scan — forecasts are embarrassingly member-parallel (zero
    collectives) and each analysis psums its O(p*(p+n)) Grams, so the
    per-cycle interconnect volume is independent of N.
    """
    x0_ens = jnp.asarray(x0_ens)
    n_ens, n_state = int(x0_ens.shape[0]), int(x0_ens.shape[1])
    y_seq = jnp.asarray(y_seq)
    if y_seq.ndim == 1:
        y_seq = y_seq[:, None]
    p = int(y_seq.shape[1])
    if method not in ("etkf", "stochastic"):
        raise ValueError(f"method must be 'etkf' or 'stochastic', "
                         f"got {method!r}")
    r_mat, r_diag = _as_r_matrix(r, p, x0_ens.dtype)
    if method == "etkf" and r_diag is None:
        raise ValueError("etkf filtering needs scalar/diagonal r; "
                         "use method='stochastic' for full R")
    q_diag = None
    if q is not None:
        q_diag = (jnp.full((n_state,), float(q), x0_ens.dtype)
                  if np.ndim(q) == 0 else jnp.asarray(q, x0_ens.dtype))
        if q_diag.shape != (n_state,):
            raise ValueError(f"q must be scalar or ({n_state},), got "
                             f"{q_diag.shape}")
    prop_v = jax.vmap(propagate)
    h_mat = None if callable(h) else jnp.asarray(h)
    infl = float(inflation)
    # chol(R) is loop-invariant: hoist it out of the scan body (XLA is
    # not guaranteed to hoist out of a while loop)
    r_chol = None if r_diag is not None else jnp.linalg.cholesky(r_mat)
    if mesh is not None:
        x0_ens = _member_shard(x0_ens, mesh, axis_name)
    else:
        from corrla_rs_tpu.utils.smallpath import maybe_route_small
        x0_ens, y_seq = maybe_route_small(
            x0_ens, y_seq,
            work_elems=int(y_seq.shape[0]) * n_ens * (n_state + p))

    def step(carry, inp):
        x_ens, k = carry
        y_t, = inp
        k, k_q, k_r = jax.random.split(k, 3)
        x_f = prop_v(x_ens)
        if q_diag is not None:
            x_f = x_f + jnp.sqrt(q_diag) * jax.random.normal(
                k_q, x_f.shape, x_f.dtype)
        if infl != 1.0:
            m = jnp.mean(x_f, axis=0)
            x_f = m + infl * (x_f - m)
        y_ens = (_obs_ensemble(x_f, h) if h_mat is None
                 else _mm(x_f, h_mat.T))
        if method == "etkf":
            x_a = _etkf_kernel(x_f, y_ens, y_t, 1.0 / r_diag)
        else:
            if r_diag is not None:
                eps = jnp.sqrt(r_diag) * jax.random.normal(
                    k_r, (n_ens, p), x_f.dtype)
            else:
                eps = _mm(jax.random.normal(k_r, (n_ens, p),
                                            x_f.dtype),
                          r_chol.T)
            eps = eps - jnp.mean(eps, axis=0)
            x_a = _enkf_kernel_obs_space(x_f, y_ens, y_t + eps, r_mat)
        mean = jnp.mean(x_a, axis=0)
        spread = jnp.mean(jnp.std(x_a, axis=0))
        return (x_a, k), (mean, spread)

    (x_final, _), (means, spreads) = jax.lax.scan(
        step, (x0_ens, key), (y_seq,))
    return {"means": means, "ensemble": x_final, "spread": spreads}


def esmda(x_ens, forward, y_obs, r, key, n_mda: int = 4,
          alphas=None, mesh=None, axis_name=None):
    """Ensemble smoother with multiple data assimilation (Emerick &
    Reynolds 2013) — ensemble Bayesian inversion of a black-box
    forward model.

    x_ens (N, d) prior parameter ensemble; forward: per-member map
    theta (d,) -> predicted data (p,) (vmapped; jax-traceable);
    y_obs (p,) the observed data; r observation-noise covariance
    (scalar / diagonal / full); n_mda tempering steps with inflation
    coefficients alphas (default n_mda repeats of n_mda; must satisfy
    sum(1/alpha) = 1 for the Gaussian-linear case to be exact).

    Returns a dict: ``ensemble`` (N, d) posterior ensemble, ``mean``,
    ``predicted`` (N, p) final forward evaluations, ``data_misfit``
    (n_mda+1,) mean normalized misfit per stage (monotone decrease is
    the convergence diagnostic).

    Multi-chip: ``mesh=`` member-shards the ensemble once; the N
    forward evaluations per stage — the expensive part of ES-MDA by
    construction — run with zero collectives, and each tempered update
    psums the same O(p*(p+d)) Grams as :func:`enkf_analysis`.
    """
    x_ens = jnp.asarray(x_ens)
    n_ens = int(x_ens.shape[0])
    if mesh is not None:
        x_ens = _member_shard(x_ens, mesh, axis_name)
    y_obs = jnp.asarray(y_obs).reshape(-1)
    p = int(y_obs.shape[0])
    if alphas is None:
        alphas = [float(n_mda)] * int(n_mda)
    alphas = [float(a) for a in alphas]
    s = sum(1.0 / a for a in alphas)
    if abs(s - 1.0) > 1e-8:
        raise ValueError(
            f"sum(1/alpha) must be 1 (got {s:.6f}); e.g. n_mda equal "
            f"coefficients of value n_mda"
        )
    r_mat, r_diag = _as_r_matrix(r, p, x_ens.dtype)
    fwd_v = jax.vmap(forward)
    misfits = []

    def _misfit(y_ens):
        resid = y_ens - y_obs
        if r_diag is not None:
            return float(jnp.mean(jnp.sum(resid**2 / r_diag, axis=1)))
        return float(jnp.mean(jnp.sum(
            resid * jnp.linalg.solve(r_mat, resid.T).T, axis=1)))

    for alpha in alphas:
        key, k_pert = jax.random.split(key)
        y_ens = fwd_v(x_ens)
        if y_ens.shape != (n_ens, p):
            raise ValueError(
                f"forward produced {y_ens.shape}, expected "
                f"({n_ens}, {p})"
            )
        misfits.append(_misfit(y_ens))
        if r_diag is not None:
            eps = jnp.sqrt(alpha * r_diag) * jax.random.normal(
                k_pert, (n_ens, p), x_ens.dtype)
        else:
            eps = _mm(jax.random.normal(k_pert, (n_ens, p),
                                        x_ens.dtype),
                      jnp.linalg.cholesky(alpha * r_mat).T)
        eps = eps - jnp.mean(eps, axis=0)
        if r_diag is not None and p > n_ens:
            x_ens = _enkf_kernel_ens_space(
                x_ens, y_ens, y_obs + eps, 1.0 / (alpha * r_diag))
        else:
            x_ens = _enkf_kernel_obs_space(
                x_ens, y_ens, y_obs + eps, alpha * r_mat)

    y_final = fwd_v(x_ens)
    misfits.append(_misfit(y_final))
    return {"ensemble": x_ens, "mean": jnp.mean(x_ens, axis=0),
            "predicted": y_final,
            "data_misfit": np.asarray(misfits)}

"""Laplace approximation: MAP + Hessian uncertainty + evidence —
EXTENSION.

The cheap deterministic member of the Bayesian toolchain (DEMC / DREAM /
stretch / HMC sample exactly; SMC integrates exactly; this
approximates): fit a Gaussian N(x_map, H^-1) at the posterior mode,
with the classic Laplace evidence

    log Z ~= ln p(x_map) + d/2 log(2 pi) - 1/2 log det H,

H = -grad^2 ln p(x_map). Exact for Gaussian posteriors; the standard
calibration baseline and initializer for the samplers (start chains
from N(x_map, H^-1) draws instead of a guess).

Accelerator shape: multi-start BFGS runs ALL restarts as one vmapped
optimization (jax.scipy BFGS is pure-jax), the Hessian comes from
``jax.hessian`` (exact, no finite differences — the reference
finite-diffs every gradient it needs, univariate_rv.rs:136-154), and
draws are one batched triangular solve.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.optimize import minimize as _jsp_minimize

from corrla_rs_tpu.utils.prng import as_key

__all__ = ["LaplaceResult", "laplace_approx", "laplace_sample"]

_LOG_2PI = float(np.log(2.0 * np.pi))


class LaplaceResult(NamedTuple):
    x_map: jnp.ndarray        # (d,) posterior mode
    cov: jnp.ndarray          # (d, d) H^-1 at the mode
    chol_cov: jnp.ndarray     # (d, d) lower Cholesky of cov
    log_evidence: float       # Laplace estimate of log integral
    ln_post_map: float        # ln p at the mode
    converged: bool           # BFGS success at the winning restart
    x_map_all: jnp.ndarray    # (n_restarts, d) every restart's endpoint


def laplace_approx(ln_post_fn: Callable, x0, n_restarts: int = 1,
                   spread: float = 1.0, key=0) -> LaplaceResult:
    """Laplace-approximate the density exp(ln_post_fn).

    ln_post_fn: UNNORMALIZED log posterior of a (d,) point (same
    contract as every sampler in the library).
    x0: (d,) starting point, or (n, d) explicit starts (overrides
    n_restarts).
    n_restarts: extra BFGS starts drawn N(x0, spread^2 I) — all run in
    ONE vmapped optimization; the highest-posterior endpoint wins
    (multimodal posteriors keep the dominant mode).
    """
    x0 = jnp.asarray(x0, jnp.result_type(float))
    if x0.ndim == 1:
        d = x0.shape[0]
        if n_restarts > 1:
            noise = spread * jax.random.normal(
                as_key(key), (n_restarts - 1, d), x0.dtype)
            starts = jnp.concatenate([x0[None], x0[None] + noise])
        else:
            starts = x0[None]
    else:
        starts = x0
        d = starts.shape[1]

    def neg(x):
        return -ln_post_fn(x)

    def solve_one(s):
        res = _jsp_minimize(neg, s, method="BFGS")
        return res.x, res.fun, res.success

    xs, funs, succ = jax.vmap(solve_one)(starts)
    funs = jnp.where(jnp.isfinite(funs), funs, jnp.inf)
    best = jnp.argmin(funs)
    x_map = xs[best]
    h = -jax.hessian(ln_post_fn)(x_map)
    h = 0.5 * (h + h.T)
    # guard: a saddle/indefinite H means the "mode" isn't one — surface it
    eigs = jnp.linalg.eigvalsh(h)
    if not bool(jnp.all(eigs > 0)):
        raise ValueError(
            "Hessian at the optimum is not positive definite "
            f"(eigs {np.asarray(eigs)}); the posterior has no proper "
            "mode there — check ln_post_fn or provide better starts")
    cov = jnp.linalg.inv(h)
    cov = 0.5 * (cov + cov.T)
    chol = jnp.linalg.cholesky(cov)
    lnp_map = float(ln_post_fn(x_map))
    log_det_h = 2.0 * float(jnp.sum(jnp.log(jnp.diagonal(
        jnp.linalg.cholesky(h)))))
    log_z = lnp_map + 0.5 * d * _LOG_2PI - 0.5 * log_det_h
    return LaplaceResult(
        x_map=x_map, cov=cov, chol_cov=chol, log_evidence=float(log_z),
        ln_post_map=lnp_map, converged=bool(succ[best]),
        x_map_all=xs,
    )


def laplace_sample(result: LaplaceResult, n_samples: int, key=0):
    """Draw (n_samples, d) from the fitted Gaussian N(x_map, cov) — e.g.
    overdispersed-but-informed chain initializations for the samplers."""
    d = result.x_map.shape[0]
    z = jax.random.normal(as_key(key), (int(n_samples), d),
                          result.x_map.dtype)
    return result.x_map[None, :] + z @ result.chol_cov.T

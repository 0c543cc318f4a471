"""Bridge sampling: model evidence from EXISTING posterior draws —
EXTENSION.

`smc_sample` (ops/smc.py) estimates the evidence by annealing a fresh
particle population; bridge sampling (Meng & Wong 1996; Gronau et al.
2017 tutorial) recovers it from draws you ALREADY have — e.g. the
output of `hmc_run`/`nuts_run`/`stretch_run` — plus cheap draws from a
fitted Gaussian proposal:

    Z = E_prop[ q(x) h(x) ] / E_post[ g(x) h(x) ],

with the OPTIMAL bridge h (minimum relative MSE among all bridges)
found by the standard fixed-point iteration on log Z. The proposal is
the moment-matched Gaussian of the posterior draws (the tutorial's
recipe), and the iteration runs entirely on log-sum-exp reductions —
one vmapped log-density evaluation per set, no model re-runs.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.utils.prng import as_key

__all__ = ["BridgeResult", "bridge_sampling_evidence"]

_LOG_2PI = float(np.log(2.0 * np.pi))


class BridgeResult(NamedTuple):
    log_evidence: float
    n_iterations: int       # fixed-point iterations to convergence
    converged: bool
    proposal_mean: jnp.ndarray
    proposal_chol: jnp.ndarray


def bridge_sampling_evidence(ln_post_fn: Callable, posterior_draws,
                             n_proposal: int | None = None, key=0,
                             n_iters: int = 100, tol: float = 1e-10,
                             ) -> BridgeResult:
    """Estimate log Z = log integral exp(ln_post_fn) from posterior draws.

    ln_post_fn: UNNORMALIZED log posterior (the same callable the
    sampler targeted). posterior_draws (n, d): post-burn-in MCMC draws
    (thin enough to be roughly independent — autocorrelation inflates
    the error, not the bias). n_proposal: Gaussian-proposal draws
    (default: match n).

    The first half of the posterior draws fits the moment-matched
    Gaussian proposal; the second half enters the bridge (Gronau et
    al.'s split avoids reusing draws for both, which biases Z upward).
    """
    draws = jnp.asarray(posterior_draws)
    if draws.ndim != 2:
        raise ValueError(f"posterior_draws must be (n, d), got "
                         f"{draws.shape}")
    n, d = draws.shape
    if n < 4 * d:
        raise ValueError(f"need >= 4*d draws to fit the proposal, got "
                         f"{n} for d={d}")
    fit_half, use_half = draws[: n // 2], draws[n // 2:]
    mu = jnp.mean(fit_half, axis=0)
    cov = jnp.cov(fit_half.T, ddof=1).reshape(d, d)
    chol = jnp.linalg.cholesky(cov + 1e-10 * jnp.eye(d, dtype=cov.dtype))

    def ln_prop(x):
        z = jax.scipy.linalg.solve_triangular(chol, (x - mu), lower=True)
        return (-0.5 * jnp.sum(z ** 2) - 0.5 * d * _LOG_2PI
                - jnp.sum(jnp.log(jnp.diagonal(chol))))

    n1 = use_half.shape[0]
    n2 = int(n_proposal) if n_proposal else n1
    z_prop = jax.random.normal(as_key(key), (n2, d), draws.dtype)
    prop_draws = mu[None, :] + z_prop @ chol.T

    # log ratios l = ln q_post - ln q_prop on both sets — the ONLY
    # device work (the vmapped log-density sweeps); everything below is
    # O(n)-scalar host algebra
    l1 = np.asarray(jax.vmap(ln_post_fn)(use_half)
                    - jax.vmap(ln_prop)(use_half), np.float64)  # post set
    l2 = np.asarray(jax.vmap(ln_post_fn)(prop_draws)
                    - jax.vmap(ln_prop)(prop_draws), np.float64)  # prop set
    s1 = n1 / (n1 + n2)
    s2 = n2 / (n1 + n2)
    log_s1, log_s2 = np.log(s1), np.log(s2)

    # scipy's logsumexp rather than the hand-rolled max-shift: it keeps
    # the all--inf edge (every proposal draw outside the posterior's
    # support) at -inf instead of the max-shift's nan, so a hopeless
    # proposal surfaces as log_evidence=-inf, not a silent NaN.
    from scipy.special import logsumexp as _lse

    # optimal-bridge fixed point on r = log Z (Meng-Wong iteration in
    # log space): r <- logmean[ exp(l2) / (s1 exp(l2) + s2 exp(r)) ]
    #              - logmean[ 1 / (s1 exp(l1) + s2 exp(r)) ]
    # Runs in HOST f64 whatever the draw dtype: per-iteration device
    # dispatch would pay ~100 round-trips, and an f32 iterate jitters at
    # eps*|log Z| so tight tolerances would never be met.
    # Degenerate-overlap guard: if EVERY proposal draw has zero
    # posterior density (l2 all -inf, e.g. a bounded-support posterior
    # with an overdispersed proposal), the bridge estimator has no
    # overlap to work with — the fixed point below would produce
    # -inf+inf = NaN. Surface the failure as a diagnosable -inf with
    # converged=False instead of a silent NaN.
    if not np.any(np.isfinite(l2)):
        return BridgeResult(
            log_evidence=float("-inf"), n_iterations=0, converged=False,
            proposal_mean=mu, proposal_chol=chol,
        )

    r = float(np.median(l2))    # robust start
    converged = False
    it = 0
    for it in range(1, int(n_iters) + 1):
        num = _lse(l2 - np.logaddexp(log_s1 + l2, log_s2 + r)) \
            - np.log(n2)
        den = _lse(-np.logaddexp(log_s1 + l1, log_s2 + r)) \
            - np.log(n1)
        r_new = float(num - den)
        if abs(r_new - r) < tol * max(1.0, abs(r_new)):
            r = r_new
            converged = True
            break
        r = r_new
    return BridgeResult(
        log_evidence=r, n_iterations=it, converged=converged,
        proposal_mean=mu, proposal_chol=chol,
    )

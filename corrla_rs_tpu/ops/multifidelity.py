"""Multi-fidelity Monte Carlo (MFMC) estimation — EXTENSION.

The reference has no outer-loop UQ machinery at all: estimating E[f] of
an expensive model means brute-force Monte Carlo on that model. MFMC
(Peherstorfer, Willcox & Gunzburger, SIAM Review 2018; SISC 2016) spends
a compute budget across a HIERARCHY of models — the expensive
high-fidelity model plus cheap correlated surrogates (exactly what this
library builds: POD/DMD ROMs, PCE/GP/RBF surrogates, SINDy models) —
with provably optimal sample allocation, and returns an UNBIASED
estimate of the high-fidelity mean with variance often 10-1000x below
single-fidelity MC at equal cost.

Estimator (models ordered high -> low fidelity, nested sample sets
m_1 <= ... <= m_K drawn from the same stream):

    y_mfmc = ybar_1(m_1) + sum_{i>=2} alpha_i [ ybar_i(m_i) - ybar_i(m_{i-1}) ]

with control-variate weights alpha_i = rho_i sigma_1 / sigma_i and the
closed-form optimal allocation

    r_i = sqrt( c_1 (rho_i^2 - rho_{i+1}^2) / (c_i (1 - rho_2^2)) ),
    m_1 = budget / (c . r),   m_i = r_i m_1.

Accelerator design: model evaluations are user callables over BATCHED inputs
(vmap/jit them once, evaluate thousands of samples per dispatch); the
statistics (pilot covariances, the estimator itself) are trivially
jitted reductions. The allocation is tiny host math on pilot statistics.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.utils.prng import as_key

__all__ = ["MfmcDesign", "MfmcResult", "mfmc_design", "mfmc_estimate",
           "control_variate_estimate"]


class MfmcDesign(NamedTuple):
    m: np.ndarray            # (K,) samples per model (nested, increasing)
    alpha: np.ndarray        # (K,) control-variate weights (alpha[0] = 1)
    variance: float          # predicted estimator variance
    mc_variance: float       # single-fidelity MC variance at equal budget
    speedup: float           # mc_variance / variance
    sigmas: np.ndarray       # (K,) pilot std devs
    rhos: np.ndarray         # (K,) pilot correlations with model 1


class MfmcResult(NamedTuple):
    mean: float              # the unbiased MFMC estimate of E[f_1]
    design: MfmcDesign
    n_evals: np.ndarray      # (K,) actual evaluations per model


def _validate_ordering(rhos, costs):
    """MFMC feasibility (Peherstorfer 2016, Thm 3.4): correlations
    strictly decreasing in magnitude and cost ratios dominating the
    squared-correlation gaps."""
    k = len(rhos)
    r2 = rhos ** 2
    r2_next = np.append(r2[1:], 0.0)
    if np.any(np.diff(np.abs(rhos)) >= 0):
        order = np.argsort(-np.abs(rhos))
        raise ValueError(
            "models must be ordered by strictly decreasing |correlation| "
            f"with the high-fidelity model; got rhos={rhos.tolist()} "
            f"(suggested order: {order.tolist()})")
    for i in range(1, k):
        lhs = costs[i - 1] / costs[i]
        rhs = (r2[i - 1] - r2_next[i - 1]) / (r2[i] - r2_next[i])
        if lhs <= rhs:
            raise ValueError(
                f"model {i} violates the MFMC cost/correlation condition "
                f"(c_{i-1}/c_{i} = {lhs:.3g} <= {rhs:.3g}); drop it — it "
                "is too expensive for the variance it explains")


def mfmc_design(sigmas, rhos, costs, budget: float) -> MfmcDesign:
    """Closed-form optimal MFMC allocation from (pilot) statistics.

    sigmas: (K,) std dev of each model's output; rhos: (K,) Pearson
    correlation of each model with model 0 (rhos[0] == 1); costs: (K,)
    cost per evaluation (any consistent unit); budget: total cost.
    """
    sigmas = np.asarray(sigmas, np.float64)
    rhos = np.asarray(rhos, np.float64)
    costs = np.asarray(costs, np.float64)
    k = sigmas.shape[0]
    if not (rhos.shape[0] == costs.shape[0] == k):
        raise ValueError("sigmas, rhos, costs must have equal length")
    if abs(rhos[0] - 1.0) > 1e-12:
        raise ValueError(f"rhos[0] must be 1 (self-correlation), got "
                         f"{rhos[0]}")
    if k > 1:
        _validate_ordering(rhos, costs)
    r2 = rhos ** 2
    r2_next = np.append(r2[1:], 0.0)
    r = np.sqrt(costs[0] * (r2 - r2_next) / (costs * (1.0 - r2[1] if k > 1
                                                      else 1.0)))
    m1 = budget / float(np.dot(costs, r))
    m = np.maximum(np.floor(m1 * r).astype(np.int64), 2)
    # enforce nesting under the floor()
    m = np.maximum.accumulate(m)
    alpha = np.where(sigmas > 0, rhos * sigmas[0] / np.where(
        sigmas > 0, sigmas, 1.0), 0.0)
    alpha[0] = 1.0
    # predicted variance (exact formula for the realized m)
    var = sigmas[0] ** 2 / m[0]
    for i in range(1, k):
        var += (1.0 / m[i - 1] - 1.0 / m[i]) * (
            alpha[i] ** 2 * sigmas[i] ** 2
            - 2.0 * alpha[i] * rhos[i] * sigmas[0] * sigmas[i])
    mc_var = sigmas[0] ** 2 / max(budget / costs[0], 1.0)
    return MfmcDesign(
        m=m, alpha=alpha, variance=float(var), mc_variance=float(mc_var),
        speedup=float(mc_var / var) if var > 0 else float("inf"),
        sigmas=sigmas, rhos=rhos)


def _pilot_stats(models, x_pilot):
    """Evaluate every model on the shared pilot inputs; return
    (sigmas, rhos) vs model 0."""
    ys = [np.asarray(jnp.ravel(m(x_pilot)), np.float64) for m in models]
    y = np.stack(ys)                       # (K, n_pilot)
    sig = y.std(axis=1, ddof=1)
    y0 = y[0] - y[0].mean()
    rho = np.array([
        1.0 if i == 0 else float(
            np.dot(y0, y[i] - y[i].mean())
            / max((len(y0) - 1) * sig[0] * sig[i], 1e-300))
        for i in range(y.shape[0])])
    return sig, rho


def mfmc_estimate(models: Sequence[Callable], sample_inputs: Callable,
                  costs, budget: float, n_pilot: int = 50, key=0,
                  design: MfmcDesign | None = None) -> MfmcResult:
    """Unbiased multi-fidelity estimate of E[models[0](X)].

    models: callables mapping a batch of inputs (n, d) -> outputs (n,)
        (jit/vmap them for throughput), ordered high fidelity first and
        then by decreasing correlation (pilot stats validate this).
    sample_inputs: callable (key, n) -> (n, d) drawing i.i.d. inputs.
    costs: (K,) cost per evaluation in any consistent unit.
    budget: total cost to spend (pilot cost is additional).
    design: skip the pilot by passing a precomputed MfmcDesign.
    """
    if len(models) < 1:
        raise ValueError("need at least one model")
    key = as_key(key)
    k_pilot, k_main = jax.random.split(key)
    if design is None:
        x_pilot = sample_inputs(k_pilot, int(n_pilot))
        sig, rho = _pilot_stats(models, x_pilot)
        design = mfmc_design(sig, rho, costs, budget)
    m = design.m
    alpha = design.alpha
    k = len(models)

    # one nested input stream: model i sees the first m[i] samples
    x_all = sample_inputs(k_main, int(m[-1]))
    means_lo = np.zeros(k)   # ybar_i over m_{i-1} samples
    means_hi = np.zeros(k)   # ybar_i over m_i samples
    n_evals = np.zeros(k, np.int64)
    for i in range(k):
        y = jnp.ravel(models[i](x_all[: int(m[i])]))
        n_evals[i] = int(m[i])
        means_hi[i] = float(jnp.mean(y))
        if i > 0:
            means_lo[i] = float(jnp.mean(y[: int(m[i - 1])]))
    est = means_hi[0]
    for i in range(1, k):
        est += alpha[i] * (means_hi[i] - means_lo[i])
    return MfmcResult(mean=float(est), design=design, n_evals=n_evals)


def control_variate_estimate(y_hi, y_lo, mu_lo: float) -> tuple[float,
                                                                float]:
    """Classical control variates with KNOWN low-fidelity mean:
    E[y_hi] ~= ybar_hi + beta (mu_lo - ybar_lo) with the optimal
    beta = cov(y_hi, y_lo)/var(y_lo) estimated from the same batch.
    Returns (estimate, variance-reduction factor vs plain MC)."""
    y_hi = jnp.ravel(jnp.asarray(y_hi))
    y_lo = jnp.ravel(jnp.asarray(y_lo))
    if y_hi.shape != y_lo.shape:
        raise ValueError("y_hi and y_lo must be paired (same shape)")
    n = y_hi.shape[0]
    dh = y_hi - jnp.mean(y_hi)
    dl = y_lo - jnp.mean(y_lo)
    var_lo = jnp.sum(dl ** 2) / (n - 1)
    cov = jnp.sum(dh * dl) / (n - 1)
    beta = cov / jnp.maximum(var_lo, jnp.finfo(y_lo.dtype).tiny)
    est = jnp.mean(y_hi) + beta * (mu_lo - jnp.mean(y_lo))
    rho2 = cov ** 2 / jnp.maximum(
        var_lo * jnp.sum(dh ** 2) / (n - 1), jnp.finfo(y_lo.dtype).tiny)
    return float(est), float(1.0 / jnp.maximum(1.0 - rho2, 1e-12))

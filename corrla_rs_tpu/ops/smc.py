"""Adaptive tempered Sequential Monte Carlo (SMC) sampler — EXTENSION.

The reference's samplers (space_samplers.rs) are single-temperature MCMC:
they cannot estimate the model evidence (normalizing constant) and mix
poorly on multimodal posteriors. Tempered SMC (Del Moral, Doucet & Jasra
2006; Chopin 2002) anneals a particle population from the prior to the
posterior through pi_beta ∝ prior * likelihood^beta and, as a free
byproduct, returns an unbiased estimate of the log-evidence
log Z = log ∫ prior * likelihood — the quantity Bayesian model comparison
needs.

Algorithm per stage (all inside ONE jitted kernel, static shapes):
1. choose the next temperature by BISECTION so the effective sample size
   of the incremental weights hits ``ess_target * n`` (Jasra et al. 2011
   adaptive tempering) — a fixed 50-iteration bisection, jit-friendly;
2. accumulate the evidence increment log mean_i exp(dbeta * lnl_i)
   (exact for the equal-weight population that resampling guarantees);
3. SYSTEMATIC resampling (lowest-variance standard scheme; one cumsum +
   searchsorted);
4. rejuvenate with ``n_mcmc`` vmapped DEMC mutation steps targeting
   pi_beta (proposals from population differences — self-tuning to the
   current population geometry, same move as ops/samplers.demc_step).

The stage loop runs eagerly on host (the number of stages is data-
dependent and small, typically 5-50); each stage is one fixed-shape jit.

Accelerator design: the population is the batch axis — every log-prob evaluation,
resample gather and mutation is one vmapped device kernel.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from corrla_rs_tpu.ops.samplers import pick_others_batched
from corrla_rs_tpu.utils.prng import as_key

__all__ = ["SmcResult", "smc_sample"]


class SmcResult(NamedTuple):
    particles: jnp.ndarray      # (n, d) posterior (beta = 1) population
    log_evidence: float         # estimate of log ∫ prior * like
    betas: jnp.ndarray          # (n_stages + 1,) temperature ladder, 0 -> 1
    ess: jnp.ndarray            # (n_stages,) ESS of each reweighting
    accept_ratios: jnp.ndarray  # (n_stages,) mutation acceptance per stage
    n_stages: int


def _ess_fraction(dbeta, lnl, n):
    """ESS/n of incremental weights exp(dbeta * lnl), equal input weights."""
    lw = dbeta * lnl
    lw = lw - jnp.max(lw)
    w = jnp.exp(lw)
    return jnp.sum(w) ** 2 / (n * jnp.sum(w ** 2))


def _next_beta(beta, lnl, ess_target, n):
    """Largest dbeta in (0, 1-beta] whose incremental ESS >= target, by
    50-sweep bisection (monotone: ESS decreases with dbeta)."""
    hi0 = 1.0 - beta

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        ok = _ess_fraction(mid, lnl, n) >= ess_target
        return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

    # if even the full remaining step keeps ESS above target, finish
    full_ok = _ess_fraction(hi0, lnl, n) >= ess_target
    lo, _ = lax.fori_loop(0, 50, body, (jnp.zeros_like(hi0), hi0))
    dbeta = jnp.where(full_ok, hi0, jnp.maximum(lo, 1e-8 * hi0))
    return beta + dbeta


def _systematic_resample(key, log_w, n):
    """Systematic resampling indices from normalized log-weights."""
    w = jnp.exp(log_w - jax.scipy.special.logsumexp(log_w))
    cdf = jnp.cumsum(w)
    u = jax.random.uniform(key, (), w.dtype)
    pos = (u + jnp.arange(n, dtype=w.dtype)) / n
    return jnp.clip(jnp.searchsorted(cdf, pos), 0, n - 1)


def _mutate(key, particles, lnp_vals, ln_target, n_mcmc, gamma, jitter):
    """n_mcmc vmapped DEMC steps on the tempered target."""
    n, d = particles.shape
    dtype = particles.dtype

    def step(carry, k):
        x, lnp_x, n_acc = carry
        k_pick, k_jit, k_acc = jax.random.split(k, 3)
        pairs = pick_others_batched(k_pick, n, 2)
        delta = x[pairs[:, 0]] - x[pairs[:, 1]]
        eps = jax.random.uniform(k_jit, (n, d), dtype, 0.0, jitter)
        prop = x + gamma * delta + eps
        lnp_p = jax.vmap(ln_target)(prop)
        alpha = jnp.exp(jnp.minimum(lnp_p - lnp_x, 0.0))
        alpha = jnp.where(jnp.isnan(alpha), 0.0, alpha)
        acc = jax.random.uniform(k_acc, (n,), dtype) < alpha
        x = jnp.where(acc[:, None], prop, x)
        lnp_x = jnp.where(acc, lnp_p, lnp_x)
        return (x, lnp_x, n_acc + jnp.sum(acc, dtype=jnp.int32)), None

    keys = jax.random.split(key, n_mcmc)
    (x, lnp_x, n_acc), _ = lax.scan(step, (particles, lnp_vals,
                                           jnp.zeros((), jnp.int32)), keys)
    return x, lnp_x, n_acc / (n_mcmc * n)


def smc_sample(ln_like: Callable, ln_prior: Callable, init_particles,
               n_mcmc: int = 5, ess_target: float = 0.5, key=0,
               max_stages: int = 100, gamma: float | None = None,
               jitter: float = 1e-12, mesh=None,
               axis_name=None) -> SmcResult:
    """Anneal ``init_particles`` (drawn from the prior) to the posterior.

    ln_like / ln_prior: per-point log-likelihood / log-prior callables
    (same signature as the DEMC/DREAM ``ln_prob_fn``s).
    ess_target: per-stage incremental effective-sample-size fraction
    (0.5 is standard; higher => more, smaller temperature steps).

    Returns an SmcResult; ``log_evidence`` estimates
    log ∫ exp(ln_prior) exp(ln_like) dx (so with a normalized prior it is
    the marginal likelihood).

    Multi-chip: ``mesh=`` particle-shards the population. Per stage the
    likelihood sweep and mutation log-probs run shard-local; the
    ESS/evidence reductions psum O(1) scalars, and only the resample
    gather and the DEMC difference-proposal gathers move the (n, d)
    population (d is the parameter dimension — tiny by MCMC standards;
    the SURVEY §2.2 chain-head contract). Same keys as the
    single-device path, so results agree at reduction-order tolerance.
    The mesh axis size must divide n.
    """
    particles = jnp.asarray(init_particles)
    n, d = particles.shape
    if gamma is None:
        gamma = 2.38 / (2.0 * d) ** 0.5
    key = as_key(key)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        ax = axis_name or mesh.axis_names[0]
        if n % mesh.shape[ax]:
            raise ValueError(
                f"mesh axis size ({mesh.shape[ax]}) must divide the "
                f"particle count ({n})")
        particles = jax.device_put(
            particles, NamedSharding(mesh, P(ax, None)))

    @functools.partial(jax.jit, static_argnames=())
    def stage(particles, beta, key):
        lnl = jax.vmap(ln_like)(particles)
        new_beta = _next_beta(beta, lnl, ess_target, n)
        dbeta = new_beta - beta
        lw = dbeta * lnl
        # evidence increment: log mean exp(dbeta * lnl) (equal weights in)
        logz_inc = jax.scipy.special.logsumexp(lw) - jnp.log(float(n))
        ess = _ess_fraction(dbeta, lnl, n) * n
        k_res, k_mut, key = jax.random.split(key, 3)
        idx = _systematic_resample(k_res, lw, n)
        resampled = particles[idx]

        def ln_target(x):
            return ln_prior(x) + new_beta * ln_like(x)

        lnp_vals = jax.vmap(ln_target)(resampled)
        mutated, _, ar = _mutate(k_mut, resampled, lnp_vals, ln_target,
                                 n_mcmc, gamma, jitter)
        return mutated, new_beta, key, logz_inc, ess, ar

    betas = [0.0]
    esses, ars = [], []
    log_z = 0.0
    beta = jnp.zeros((), particles.dtype)
    for _ in range(max_stages):
        particles, beta, key, logz_inc, ess, ar = stage(particles, beta, key)
        beta_f = float(beta)
        betas.append(beta_f)
        esses.append(float(ess))
        ars.append(float(ar))
        log_z += float(logz_inc)
        if beta_f >= 1.0 - 1e-12:
            break
    else:
        raise RuntimeError(
            f"SMC did not reach beta=1 in {max_stages} stages "
            f"(reached {betas[-1]:.4f}); raise max_stages or n_mcmc, or "
            "check the likelihood for pathologies")
    return SmcResult(
        particles=particles,
        log_evidence=log_z,
        betas=jnp.asarray(betas),
        ess=jnp.asarray(esses),
        accept_ratios=jnp.asarray(ars),
        n_stages=len(esses),
    )

"""Hamiltonian Monte Carlo with dual-averaging adaptation — EXTENSION.

Every sampler in the reference (space_samplers.rs) — and the DEMC/
DREAM/stretch/SMC family built around it here — is GRADIENT-FREE: cost
per effective sample grows quickly with dimension (random-walk-like
mixing). JAX gives exact gradients of any log-density for free, so the
missing member of the family is the gradient-based one: HMC (Duane 1987;
Neal 2011), whose leapfrog trajectories move O(1) distance per proposal
in high dimensions where diffusive samplers move O(1/sqrt(d)).

Implementation (Stan-style single-phase warmup, then frozen kernel):
- leapfrog integrator with a diagonal mass matrix;
- step size adapted by Nesterov dual averaging to a target acceptance
  (0.8 default — Hoffman & Gelman 2014, Algorithm 5);
- diagonal mass (inverse metric) estimated from warmup second moments,
  applied for the post-warmup run;
- divergences (non-finite Hamiltonian) auto-rejected and counted.

Accelerator shape: all chains advance in ONE vmapped leapfrog — the
gradient evaluation is a single batched call as dense matmuls for log-probs
built from matmuls — and the generation loop is ``lax.scan``. The whole
warmup+run is two ``lax.scan`` programs; no per-step host sync.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from corrla_rs_tpu.utils.prng import as_key

__all__ = ["HmcResult", "hmc_run"]


class HmcResult(NamedTuple):
    history: jnp.ndarray        # (n_steps, n_chains, d) post-warmup draws
    final: jnp.ndarray          # (n_chains, d)
    accept_ratio: float         # post-warmup mean acceptance probability
    step_size: float            # adapted leapfrog step size
    inv_mass: jnp.ndarray       # (d,) adapted diagonal inverse mass
    n_divergent: int            # post-warmup divergence count


def _leapfrog(grad_fn, x, p, eps, inv_mass, n_steps):
    """n_steps leapfrog steps for all chains at once. x, p: (c, d).

    The gradient is CARRIED through the loop: the closing half-kick of
    step i and the opening half-kick of step i+1 use the same grad(x),
    and XLA cannot CSE across fori_loop iterations — carrying it halves
    the gradient evaluations (n+1 instead of 2n)."""
    def body(_, carry):
        x, p, g = carry
        p_half = p + 0.5 * eps * g
        x = x + eps * (p_half * inv_mass)
        g = grad_fn(x)
        p = p_half + 0.5 * eps * g
        return x, p, g

    x, p, _g = lax.fori_loop(0, n_steps, body, (x, p, grad_fn(x)))
    return x, p


def _kinetic(p, inv_mass):
    return 0.5 * jnp.sum(p * p * inv_mass, axis=-1)


def hmc_run(init_chains, ln_prob_fn: Callable, n_steps: int,
            n_warmup: int = 500, n_leapfrog: int = 32,
            target_accept: float = 0.8, init_step_size: float = 0.1,
            key=0, adapt_mass: bool = True, jitter_steps: bool = False,
            mesh=None, axis_name=None) -> HmcResult:
    """Run HMC on ``n_chains`` parallel chains.

    init_chains (n_chains, d): overdispersed starting points.
    ln_prob_fn: per-point log density (same contract as the other
    samplers); its gradient comes from ``jax.grad`` automatically.

    Warmup adapts the step size (dual averaging to ``target_accept``)
    and, if ``adapt_mass``, a diagonal inverse mass from the warmup
    draws' second moments; both freeze for the sampling phase, so the
    post-warmup history is a valid MCMC chain set.

    Multi-chip: chains are INDEPENDENT (unlike DEMC/DREAM/stretch, no
    cross-chain coupling), so ``mesh=`` simply places the chain axis
    sharded and GSPMD partitions every batched gradient/leapfrog with
    no collectives in the hot loop; the only cross-chain reductions are
    the scalar dual-averaging statistic and the warmup moments, whose
    reassociated summation order makes the adapted step size differ at
    float-rounding level — the sharded run is statistically identical,
    not bitwise.
    """
    x0 = jnp.asarray(init_chains)
    if x0.ndim != 2:
        raise ValueError(f"init_chains must be (n_chains, d), got "
                         f"{x0.shape}")
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        ax = axis_name or mesh.axis_names[0]
        n_dev = mesh.shape[ax]
        if x0.shape[0] % n_dev != 0:
            raise ValueError(
                f"mesh axis size ({n_dev}) must divide n_chains "
                f"({x0.shape[0]})")
        x0 = jax.device_put(x0, NamedSharding(mesh, P(ax, None)))
    n_chains, d = x0.shape
    dtype = x0.dtype
    key = as_key(key)

    lnp_batched = jax.vmap(ln_prob_fn)
    grad_batched = jax.vmap(jax.grad(ln_prob_fn))

    def transition(x, lnp_x, eps, inv_mass, k):
        k_mom, k_len, k_acc = jax.random.split(k, 3)
        p0 = jax.random.normal(k_mom, x.shape, dtype) / jnp.sqrt(inv_mass)
        if jitter_steps:
            # uniform trajectory-length jitter (Neal 2011 §3.2): breaks
            # the periodicity resonances a FIXED length has on targets
            # whose oscillation period divides eps * n_leapfrog. Run the
            # full n_leapfrog loop (static shape) but freeze the state
            # after a random cutoff — masked no-op iterations, the house
            # pattern for batched-friendly loops.
            cutoff = jax.random.randint(k_len, (), 1, n_leapfrog + 1)

            def body(i, carry):
                xc, pc, gc = carry
                live = i < cutoff
                pc2 = pc + 0.5 * eps * gc
                xc2 = xc + eps * (pc2 * inv_mass)
                gc2 = grad_batched(xc2)
                pc2 = pc2 + 0.5 * eps * gc2
                return (jnp.where(live, xc2, xc),
                        jnp.where(live, pc2, pc),
                        jnp.where(live, gc2, gc))

            x_new, p_new, _g = lax.fori_loop(
                0, n_leapfrog, body, (x, p0, grad_batched(x)))
        else:
            x_new, p_new = _leapfrog(grad_batched, x, p0, eps, inv_mass,
                                     n_leapfrog)
        lnp_new = lnp_batched(x_new)
        h0 = -lnp_x + _kinetic(p0, inv_mass)
        h1 = -lnp_new + _kinetic(p_new, inv_mass)
        log_alpha = jnp.minimum(h0 - h1, 0.0)
        divergent = ~jnp.isfinite(log_alpha)
        log_alpha = jnp.where(divergent, -jnp.inf, log_alpha)
        accept = (jnp.log(jax.random.uniform(k_acc, (n_chains,), dtype))
                  < log_alpha)
        x = jnp.where(accept[:, None], x_new, x)
        lnp_x = jnp.where(accept, lnp_new, lnp_x)
        # mean Metropolis probability (the dual-averaging statistic)
        a_stat = jnp.mean(jnp.exp(log_alpha))
        return x, lnp_x, a_stat, jnp.sum(divergent, dtype=jnp.int32)

    # -- warmup: dual averaging of log(eps), Hoffman-Gelman constants --
    gamma, t0, kappa = 0.05, 10.0, 0.75

    def dual_avg_phase(x, lnp_x, keys, eps0, inv_mass):
        """One dual-averaging phase at a FIXED metric."""
        mu = jnp.log(10.0) + jnp.log(eps0)

        def warm_body(carry, k):
            x, lnp_x, log_eps, log_eps_bar, h_bar, t = carry
            x, lnp_x, a_stat, _ = transition(x, lnp_x, jnp.exp(log_eps),
                                             inv_mass, k)
            t = t + 1.0
            h_bar = ((1.0 - 1.0 / (t + t0)) * h_bar
                     + (target_accept - a_stat) / (t + t0))
            log_eps = mu - jnp.sqrt(t) / gamma * h_bar
            w = t ** (-kappa)
            log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
            return (x, lnp_x, log_eps, log_eps_bar, h_bar, t), x

        (x, lnp_x, _, log_eps_bar, _, _), hist = lax.scan(
            warm_body,
            (x, lnp_x, jnp.log(eps0), jnp.log(eps0),
             jnp.zeros((), dtype), jnp.zeros((), dtype)),
            keys,
        )
        return x, lnp_x, jnp.exp(log_eps_bar), hist

    lnp0 = lnp_batched(x0)
    keys_w = jax.random.split(key, int(n_warmup) + 1)
    do_mass = adapt_mass and n_warmup >= 20
    # phase 1: unit metric (2/3 of warmup when a mass re-adapt follows)
    n1 = (2 * int(n_warmup)) // 3 if do_mass else int(n_warmup)
    eps0 = jnp.asarray(init_step_size, dtype)
    x, lnp_x, eps, warm_hist = dual_avg_phase(
        x0, lnp0, keys_w[1: n1 + 1], eps0, jnp.ones((d,), dtype))
    if do_mass:
        # metric from the settled half of phase 1, then RE-ADAPT eps
        # under the new metric (a unit-metric eps is wrong for it —
        # Stan's windowed warmup re-tunes after every metric update)
        tail = warm_hist[n1 // 2:].reshape(-1, d)
        inv_mass = jnp.var(tail, axis=0) + 1e-6
        x, lnp_x, eps, _ = dual_avg_phase(
            x, lnp_x, keys_w[n1 + 1:], eps, inv_mass)
    else:
        inv_mass = jnp.ones((d,), dtype)

    # -- sampling: frozen kernel --
    def samp_body(carry, k):
        x, lnp_x, acc_sum, div_sum = carry
        x, lnp_x, a_stat, n_div = transition(x, lnp_x, eps, inv_mass, k)
        return (x, lnp_x, acc_sum + a_stat, div_sum + n_div), x

    keys_s = jax.random.split(keys_w[0], int(n_steps))
    (x, lnp_x, acc_sum, div_sum), hist = lax.scan(
        samp_body,
        (x, lnp_x, jnp.zeros((), dtype), jnp.zeros((), jnp.int32)),
        keys_s,
    )
    return HmcResult(
        history=hist,
        final=x,
        accept_ratio=float(acc_sum / n_steps),
        step_size=float(eps),
        inv_mass=inv_mass,
        n_divergent=int(div_sum),
    )

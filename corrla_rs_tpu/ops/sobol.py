"""Variance-based global sensitivity: Sobol' indices (extension).

The reference's only global-sensitivity method is the active-subspace
measure (readme.md:22-24, active_subspaces.rs); this module adds the other
standard tool, Sobol' first-order and total-effect indices, with the
Saltelli (2010) / Jansen (1999) pick-freeze estimators:

    S1_i = mean(f(B) * (f(AB_i) - f(A))) / Var(f)       (first order)
    ST_i = 0.5 * mean((f(A) - f(AB_i))^2) / Var(f)      (total effect)

where A, B are two independent sample matrices and AB_i is A with column
i replaced by B's. Accelerator shape: all (d + 2) * n model evaluations are
stacked into ONE batched call to the (vectorized, ideally jitted) model,
so the device sees a single large batch; the estimator itself is a handful
of reductions. Bootstrap confidence intervals resample evaluation ROWS
(no re-evaluation) and are vmapped.

Sampling plans: plain Monte Carlo via ``jax.random.uniform`` (default,
fully on-device) or a scrambled Sobol' low-discrepancy plan via
scipy.stats.qmc on host (``plan="sobol"`` — plan generation is setup
work; the evaluations still run on device). The qmc plan typically cuts
the estimator noise by ~an order of magnitude at equal n.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.design import _box, _seed_from_key
from corrla_rs_tpu.utils.prng import as_key

__all__ = ["saltelli_plan", "sobol_indices"]


def saltelli_plan(bounds, n_base: int, key=0, plan: str = "uniform"):
    """(A, B, AB) sample matrices for the pick-freeze estimators.

    bounds: (d, 2) [lo, hi] per input. Returns
    ``(a (n, d), b (n, d), ab (d, n, d))`` with ``ab[i]`` = A with column
    i swapped for B's.

    plan="uniform": i.i.d. uniforms from ``jax.random`` (on device).
    plan="sobol": scrambled Sobol' sequence from scipy.stats.qmc (host
    setup; first 2d dims split into the A | B halves per Saltelli 2010).
    """
    d, lo, span = _box(bounds)

    if plan == "sobol":
        from scipy.stats import qmc

        u = qmc.Sobol(2 * d, scramble=True,
                      seed=_seed_from_key(key)).random(n_base)
        ua = jnp.asarray(u[:, :d])
        ub = jnp.asarray(u[:, d:])
    elif plan == "uniform":
        k1, k2 = jax.random.split(as_key(key))
        ua = jax.random.uniform(k1, (n_base, d))
        ub = jax.random.uniform(k2, (n_base, d))
    else:
        raise ValueError(f"plan must be 'uniform' or 'sobol', got {plan!r}")

    a = lo + ua * span
    b = lo + ub * span
    eye = jnp.eye(d, dtype=bool)
    # ab[i] = a with column i from b
    ab = jnp.where(eye[:, None, :], b[None, :, :], a[None, :, :])
    return a, b, ab


def sobol_indices(f, bounds, n_base: int, key=0, plan: str = "uniform",
                  n_boot: int = 0, boot_key=1):
    """First-order and total-effect Sobol' indices of ``f`` over a box.

    f: vectorized model, (n, d) -> (n,) or (n, 1). Evaluated ONCE on the
    stacked ((d + 2) * n_base, d) design.
    Returns a dict: ``s1`` (d,), ``st`` (d,), ``var`` (scalar), ``mean``;
    with ``n_boot`` > 0 adds percentile bands ``s1_lo/s1_hi/st_lo/st_hi``
    (2.5/97.5%) from row-resampled bootstrap replicates (no new model
    evaluations).
    """
    a, b, ab = saltelli_plan(bounds, n_base, key=key, plan=plan)
    n, d = a.shape
    x_all = jnp.concatenate([a, b, ab.reshape(d * n, d)], axis=0)
    y_all = jnp.asarray(f(x_all)).reshape(-1)
    if y_all.shape[0] != (d + 2) * n:
        raise ValueError(
            f"model returned {y_all.shape[0]} outputs for {(d + 2) * n} "
            "inputs; f must be vectorized (n, d) -> (n,)"
        )
    f_a = y_all[:n]
    f_b = y_all[n:2 * n]
    f_ab = y_all[2 * n:].reshape(d, n)

    def estimate(f_a, f_b, f_ab):
        mu = 0.5 * (jnp.mean(f_a) + jnp.mean(f_b))
        var = 0.5 * (jnp.var(f_a) + jnp.var(f_b))
        var = jnp.maximum(var, jnp.asarray(jnp.finfo(f_a.dtype).tiny,
                                           f_a.dtype))
        s1 = jnp.mean(f_b[None, :] * (f_ab - f_a[None, :]), axis=1) / var
        st = 0.5 * jnp.mean((f_a[None, :] - f_ab) ** 2, axis=1) / var
        return mu, var, s1, st

    mu, var, s1, st = estimate(f_a, f_b, f_ab)
    out = {"mean": mu, "var": var, "s1": s1, "st": st}

    if n_boot > 0:
        def one(k):
            idx = jax.random.randint(k, (n,), 0, n)
            _mu, _v, s1_b, st_b = estimate(
                f_a[idx], f_b[idx], f_ab[:, idx]
            )
            return s1_b, st_b

        keys = jax.random.split(as_key(boot_key), int(n_boot))
        s1_bs, st_bs = jax.vmap(one)(keys)
        qs = jnp.array([0.025, 0.975])
        s1_q = jnp.quantile(s1_bs, qs, axis=0)
        st_q = jnp.quantile(st_bs, qs, axis=0)
        out.update(
            s1_lo=s1_q[0], s1_hi=s1_q[1], st_lo=st_q[0], st_hi=st_q[1]
        )
    return out

"""CMA-ES: covariance matrix adaptation evolution strategy — EXTENSION.

The reference's only derivative-free optimizer is argmin's particle
swarm (univariate_rv.rs:24-83), kept here as ops/optimize's PSO
fallback. CMA-ES (Hansen & Ostermeier 2001; Hansen 2016 tutorial) is
the stronger general-purpose black-box optimizer: it ADAPTS a full
covariance to the objective's local geometry, giving near-Newton
behavior on ill-conditioned valleys where PSO and isotropic strategies
stall. This is the standard (mu/mu_w, lambda) algorithm: rank-mu +
rank-one covariance updates, cumulative step-size adaptation (CSA),
log-decreasing recombination weights.

Accelerator shape: a generation is ONE batched objective evaluation of
the full population (vmap for jax objectives) plus small-matrix updates
(one (d, d) eigh per generation for the sampling transform); the
generation loop runs under ``lax.scan`` when the objective is
jax-traceable and eagerly otherwise (plain numpy/black-box callables
work unchanged).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from corrla_rs_tpu.utils.prng import as_key

__all__ = ["CmaResult", "cma_es"]


class CmaResult(NamedTuple):
    x_best: jnp.ndarray       # (d,) best point ever evaluated
    f_best: float
    mean: jnp.ndarray         # (d,) final distribution mean
    sigma: float              # final global step size
    history: jnp.ndarray      # (n_gens,) per-generation best f
    n_evals: int


def _params(d: int, pop: int):
    mu = pop // 2
    w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
    w = w / w.sum()
    mu_eff = 1.0 / np.sum(w ** 2)
    c_sigma = (mu_eff + 2.0) / (d + mu_eff + 5.0)
    d_sigma = 1.0 + 2.0 * max(0.0, np.sqrt((mu_eff - 1.0) / (d + 1.0))
                              - 1.0) + c_sigma
    c_c = (4.0 + mu_eff / d) / (d + 4.0 + 2.0 * mu_eff / d)
    c_1 = 2.0 / ((d + 1.3) ** 2 + mu_eff)
    c_mu = min(1.0 - c_1,
               2.0 * (mu_eff - 2.0 + 1.0 / mu_eff)
               / ((d + 2.0) ** 2 + mu_eff))
    chi_n = np.sqrt(d) * (1.0 - 1.0 / (4.0 * d) + 1.0 / (21.0 * d * d))
    return (mu, jnp.asarray(w), float(mu_eff), float(c_sigma),
            float(d_sigma), float(c_c), float(c_1), float(c_mu),
            float(chi_n))


def cma_es(fn: Callable, x0, sigma0: float = 0.5, n_gens: int = 200,
           pop_size: int | None = None, key=0,
           bounds=None, mesh=None, axis_name=None) -> CmaResult:
    """Minimize ``fn`` from ``x0`` with initial step scale ``sigma0``.

    fn: (d,) -> scalar. jax-traceable objectives run the WHOLE
    optimization as one jitted lax.scan (vmapped population
    evaluations); non-traceable ones fall back to an eager generation
    loop around the same jitted update.
    bounds: optional (d, 2) box — candidates are clipped before
    evaluation (simple projection; the distribution itself is
    unconstrained).
    mesh: optional ``jax.sharding.Mesh`` — population-shards each
    generation's candidate matrix so the objective evaluations (the
    expensive part for simulation-backed objectives) run shard-local;
    the only cross-device traffic is the (pop,) fitness gather feeding
    the selection argsort, and the (d, d) distribution updates stay
    replicated. Requires a jax-traceable objective and
    pop_size % n_devices == 0. Same answer as single-device up to
    float reassociation.
    """
    x0 = jnp.asarray(x0, jnp.result_type(float))
    d = x0.shape[0]
    pop = int(pop_size) if pop_size else 4 + int(3 * np.log(d))
    pop = max(pop, 4)
    pop_sharding = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        ax = axis_name or mesh.axis_names[0]
        n_dev = mesh.shape[ax]
        if pop % n_dev != 0:
            raise ValueError(
                f"mesh axis size ({n_dev}) must divide pop_size ({pop})")
        pop_sharding = NamedSharding(mesh, P(ax, None))
    (mu, w, mu_eff, c_sigma, d_sigma, c_c, c_1, c_mu,
     chi_n) = _params(d, pop)
    dtype = x0.dtype
    lo = hi = None
    if bounds is not None:
        b = np.asarray(bounds, np.float64)
        lo, hi = jnp.asarray(b[:, 0], dtype), jnp.asarray(b[:, 1], dtype)

    def gen_update(state, k):
        (mean, sigma, cov, p_sig, p_c, ngen, x_best, f_best) = state
        # sampling transform from the eigendecomposition (also gives
        # C^-1/2 for the CSA path length)
        eigval, eigvec = jnp.linalg.eigh(cov)
        eigval = jnp.maximum(eigval, 1e-20)
        sq = eigvec * jnp.sqrt(eigval)[None, :]          # C^1/2
        inv_sq = eigvec * (1.0 / jnp.sqrt(eigval))[None, :]
        z = jax.random.normal(k, (pop, d), dtype)
        y = z @ sq.T                                      # N(0, C)
        xs = mean[None, :] + sigma * y
        if lo is not None:
            xs = jnp.clip(xs, lo[None, :], hi[None, :])
            y = (xs - mean[None, :]) / sigma
        if pop_sharding is not None:
            # pin the population axis over the mesh: candidate evals run
            # shard-local; only the (pop,) fitness vector crosses devices
            xs = jax.lax.with_sharding_constraint(xs, pop_sharding)
            y = jax.lax.with_sharding_constraint(y, pop_sharding)
        fs = eval_pop(xs)
        order = jnp.argsort(fs)
        y_sel = y[order[:mu]]                             # (mu, d)
        y_w = w @ y_sel                                   # (d,)
        mean = mean + sigma * y_w
        # CSA
        # C^-1/2 y_w = V diag(1/sqrt(lam)) V^T y_w
        whitened = inv_sq @ (eigvec.T @ y_w)
        p_sig = ((1.0 - c_sigma) * p_sig
                 + jnp.sqrt(c_sigma * (2.0 - c_sigma) * mu_eff)
                 * whitened)
        sigma = sigma * jnp.exp(
            (c_sigma / d_sigma)
            * (jnp.linalg.norm(p_sig) / chi_n - 1.0))
        # rank-one path (with stall guard h_sigma)
        ngen = ngen + 1
        h_sig = (jnp.linalg.norm(p_sig)
                 / jnp.sqrt(1.0 - (1.0 - c_sigma) ** (2.0 * ngen))
                 < (1.4 + 2.0 / (d + 1.0)) * chi_n).astype(dtype)
        p_c = ((1.0 - c_c) * p_c
               + h_sig * jnp.sqrt(c_c * (2.0 - c_c) * mu_eff) * y_w)
        rank_mu = jnp.einsum("i,ij,ik->jk", w, y_sel, y_sel)
        cov = ((1.0 - c_1 - c_mu) * cov
               + c_1 * (jnp.outer(p_c, p_c)
                        + (1.0 - h_sig) * c_c * (2.0 - c_c) * cov)
               + c_mu * rank_mu)
        cov = 0.5 * (cov + cov.T)
        # best-ever tracking
        i0 = order[0]
        better = fs[i0] < f_best
        x_best = jnp.where(better, xs[i0], x_best)
        f_best = jnp.where(better, fs[i0], f_best)
        return ((mean, sigma, cov, p_sig, p_c, ngen, x_best, f_best),
                fs[i0])

    # batched objective: try vmap (jax objective), else eager map
    try:
        eval_pop = jax.vmap(fn)
        _ = jax.eval_shape(eval_pop, jax.ShapeDtypeStruct((pop, d), dtype))
        traceable = True
    except Exception:
        traceable = False

        def eval_pop(xs):
            return jnp.asarray([float(fn(np.asarray(p))) for p in xs])

    if mesh is not None and not traceable:
        raise ValueError(
            "mesh= requires a jax-traceable objective (the eager "
            "black-box path evaluates candidates on the host)")

    state = (x0, jnp.asarray(float(sigma0), dtype),
             jnp.eye(d, dtype=dtype),
             jnp.zeros(d, dtype), jnp.zeros(d, dtype),
             jnp.zeros((), dtype), x0,
             jnp.asarray(jnp.inf, dtype))
    keys = jax.random.split(as_key(key), int(n_gens))
    if traceable:
        scan_all = lambda s, ks: lax.scan(gen_update, s, ks)  # noqa: E731
        if mesh is not None:
            # explicit jit so the sharding constraints reach GSPMD as
            # one partitioned program (eager scan would run per-gen)
            scan_all = jax.jit(scan_all)
        state, hist = scan_all(state, keys)
        hist = jnp.asarray(hist)
    else:
        hist_l = []
        for k in keys:
            state, fb = gen_update(state, k)
            hist_l.append(float(fb))
        hist = jnp.asarray(hist_l)
    mean, sigma, _c, _ps, _pc, _ng, x_best, f_best = state
    return CmaResult(
        x_best=x_best, f_best=float(f_best), mean=mean,
        sigma=float(sigma), history=hist,
        n_evals=int(n_gens) * pop,
    )

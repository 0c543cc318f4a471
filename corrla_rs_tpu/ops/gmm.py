"""Gaussian mixture models by EM — EXTENSION (no reference analogue;
fills the multivariate density-estimation / clustering gap next to the
univariate KDE in ops/univariate_rv and gives the sampling stack a
fittable proposal family: a GMM fitted to posterior draws is the
standard adaptive proposal for importance sampling (pairs with
ops/psis) and the moment-matched bridge proposal (ops/bridge).

Accelerator shape: one EM iteration is three dense batched kernels —
(n, k) log-density matrix from a vmapped Cholesky whitening (dense
matmuls over components), a logsumexp row reduction for
responsibilities, and weighted-Gram M-step updates — with the WHOLE EM
loop a lax.scan at static iteration count (convergence is detected by
a masked "freeze" predicate, not a dynamic break, so one compiled
program serves every run of the same shape). k-means++ init runs as a
fori_loop over k distance updates.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.utils.prng import as_key, split_key

__all__ = ["GmmFit", "gmm_fit", "gmm_logpdf", "gmm_sample",
           "gmm_select"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


class GmmFit(NamedTuple):
    """Fitted mixture: weights (k,), means (k, d), covs (k, d, d),
    log_likelihood (scalar, final total), n_iter (iterations until the
    freeze predicate fired), responsibilities (n, k) at the optimum,
    cov_type ('full' or 'diag' — recorded so BIC/AIC count the right
    number of covariance parameters)."""
    weights: jax.Array
    means: jax.Array
    covs: jax.Array
    log_likelihood: jax.Array
    n_iter: jax.Array
    responsibilities: jax.Array
    cov_type: str = "full"

    @property
    def n_components(self) -> int:
        return int(self.weights.shape[0])

    def _n_params(self) -> int:
        k, d = self.means.shape
        # diag fits estimate k*d variances, full fits k*d*(d+1)/2
        cov_params = k * d if self.cov_type == "diag" \
            else k * d * (d + 1) // 2
        return k - 1 + k * d + cov_params

    def bic(self, n: int | None = None) -> float:
        """Bayesian information criterion (lower = better)."""
        n = int(self.responsibilities.shape[0]) if n is None else int(n)
        return float(self._n_params() * np.log(n)
                     - 2.0 * float(self.log_likelihood))

    def aic(self) -> float:
        return float(2.0 * self._n_params()
                     - 2.0 * float(self.log_likelihood))


def _component_logpdf(x, means, chols):
    """(n, k) log N(x | mu_j, L_j L_j^T) via vmapped triangular solves
    (backward stable; no explicit inverse)."""
    d = x.shape[1]

    def one(mu, chol):
        diff = x - mu                                       # (n, d)
        z = jax.scipy.linalg.solve_triangular(
            chol, diff.T, lower=True)                       # (d, n)
        logdet = jnp.sum(jnp.log(jnp.diagonal(chol)))
        return (-0.5 * jnp.sum(z * z, axis=0) - logdet
                - 0.5 * d * jnp.log(2.0 * jnp.asarray(np.pi, x.dtype)))

    return jax.vmap(one)(means, chols).T                    # (n, k)


def _kmeanspp_init(key, x, k):
    """k-means++ seeding as a fori_loop: each round picks the next
    center with probability proportional to squared distance from the
    chosen set."""
    n = x.shape[0]
    keys = jax.random.split(key, k)
    first = jax.random.randint(keys[0], (), 0, n)
    centers0 = jnp.zeros((k, x.shape[1]), x.dtype).at[0].set(x[first])
    d2_0 = jnp.sum((x - x[first]) ** 2, axis=1)

    def body(j, state):
        centers, d2 = state
        p = d2 / jnp.maximum(jnp.sum(d2), jnp.finfo(x.dtype).tiny)
        idx = jax.random.categorical(keys[j], jnp.log(p + 1e-30))
        c = x[idx]
        centers = centers.at[j].set(c)
        d2 = jnp.minimum(d2, jnp.sum((x - c) ** 2, axis=1))
        return centers, d2

    centers, _ = jax.lax.fori_loop(1, k, body, (centers0, d2_0))
    return centers


@functools.partial(jax.jit,
                   static_argnames=("k", "n_iter", "cov_type"))
def _gmm_em_kernel(x, key, k, n_iter, cov_type, reg, tol):
    n, d = x.shape
    dt = x.dtype
    means0 = _kmeanspp_init(key, x, k)
    covs0 = jnp.broadcast_to(
        jnp.diag(jnp.var(x, axis=0) + reg), (k, d, d)).astype(dt)
    w0 = jnp.full((k,), 1.0 / k, dt)

    def e_step(w, means, covs):
        chols = jnp.linalg.cholesky(covs)
        lp = _component_logpdf(x, means, chols) + jnp.log(w)  # (n, k)
        norm = jax.scipy.special.logsumexp(lp, axis=1)
        return jnp.exp(lp - norm[:, None]), jnp.sum(norm)

    def m_step(resp):
        nk = jnp.sum(resp, axis=0) + 1e-12                  # (k,)
        w = nk / n
        means = _mm(resp.T, x) / nk[:, None]                # (k, d)

        def cov_one(r_col, mu, n_eff):
            diff = x - mu
            c = _mm(diff.T * r_col[None, :], diff) / n_eff
            if cov_type == "diag":
                c = jnp.diag(jnp.diagonal(c))
            return c + reg * jnp.eye(d, dtype=dt)

        covs = jax.vmap(cov_one)(resp.T, means, nk)
        return w, means, covs

    def step(carry, _):
        w, means, covs, ll_prev, frozen, it = carry
        resp, ll = e_step(w, means, covs)
        w_new, m_new, c_new = m_step(resp)
        # non-finite ll_prev (the -inf init) always counts as improved
        improved = ~jnp.isfinite(ll_prev) \
            | ((ll - ll_prev) > tol * jnp.abs(ll_prev))
        now_frozen = frozen | ~improved
        # freeze: once converged, keep the parameters fixed so the scan
        # finishes without changing the answer
        w = jnp.where(now_frozen, w, w_new)
        means = jnp.where(now_frozen, means, m_new)
        covs = jnp.where(now_frozen, covs, c_new)
        it = it + jnp.where(now_frozen, 0, 1)
        return (w, means, covs, ll, now_frozen, it), None

    init = (w0, means0, covs0, jnp.asarray(-jnp.inf, dt),
            jnp.asarray(False), jnp.asarray(0, jnp.int32))
    (w, means, covs, ll, _, it), _ = jax.lax.scan(
        step, init, None, length=n_iter)
    resp, ll_final = e_step(w, means, covs)
    return w, means, covs, ll_final, it, resp


def gmm_fit(x, n_components: int, key=0, n_iter: int = 200,
            cov_type: str = "full", reg: float = 1e-6,
            tol: float = 1e-7, mesh=None, axis_name=None) -> GmmFit:
    """Fit a Gaussian mixture with EM (k-means++ init).

    x (n, d) data; n_components: mixture size k; key: int seed or PRNG
    key for the init; n_iter: scan length (an iteration freezes early
    once the total log-likelihood gain drops below ``tol`` relative —
    check ``fit.n_iter``); cov_type 'full' or 'diag'; reg: diagonal
    regularization added to every covariance (keeps Cholesky alive
    when a component collapses onto few points).

    Multi-chip: ``mesh=`` row-shards the data over ``axis_name`` (first
    mesh axis by default; the axis size must divide n). Each EM
    iteration's E-step log-density matrix stays shard-local and the
    M-step reduces psum'd O(k d^2) sufficient statistics — the same
    psum-Gram contract as parallel/sharded_rsvd (GSPMD inserts the
    collectives from the sharding annotation). Same keys as the
    single-device path, so results agree to reduction-order tolerance.

    Returns :class:`GmmFit`. Monotone EM ascent, agreement with
    sklearn's GaussianMixture optimum, and label recovery on separated
    clusters are tested.
    """
    x = jnp.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    n = int(x.shape[0])
    k = int(n_components)
    if not 1 <= k <= n:
        raise ValueError(f"n_components must be in [1, {n}], got {k}")
    if cov_type not in ("full", "diag"):
        raise ValueError("cov_type must be 'full' or 'diag', got "
                         f"{cov_type!r}")
    key = as_key(key)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        ax = axis_name or mesh.axis_names[0]
        if n % mesh.shape[ax]:
            raise ValueError(
                f"mesh axis size ({mesh.shape[ax]}) must divide the "
                f"row count ({n})")
        x = jax.device_put(x, NamedSharding(mesh, P(ax, None)))
    else:
        from corrla_rs_tpu.utils.smallpath import maybe_route_small
        (x,) = maybe_route_small(
            x, work_elems=n * k * int(x.shape[1]) ** 2)
    w, means, covs, ll, it, resp = _gmm_em_kernel(
        x, key, k, int(n_iter), cov_type,
        jnp.asarray(reg, x.dtype), jnp.asarray(tol, x.dtype))
    return GmmFit(w, means, covs, ll, it, resp, cov_type)


def gmm_logpdf(fit: GmmFit, x):
    """Mixture log-density at query points x (m, d) -> (m,)."""
    x = jnp.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    chols = jnp.linalg.cholesky(fit.covs)
    lp = _component_logpdf(x, fit.means, chols) \
        + jnp.log(fit.weights)
    return jax.scipy.special.logsumexp(lp, axis=1)


def gmm_sample(fit: GmmFit, key, n: int):
    """Draw n samples: categorical component choice + vmapped
    Cholesky-colored normals (one gather, no per-sample branching)."""
    k_comp, k_norm = split_key(key, 2)
    comp = jax.random.categorical(
        k_comp, jnp.log(fit.weights), shape=(int(n),))
    chols = jnp.linalg.cholesky(fit.covs)
    z = jax.random.normal(
        k_norm, (int(n), fit.means.shape[1]), fit.means.dtype)
    mu = fit.means[comp]                                    # (n, d)
    ch = chols[comp]                                        # (n, d, d)
    return mu + jnp.einsum("nij,nj->ni", ch, z,
                           precision=PRECISION)


def gmm_select(x, k_range, key=0, criterion: str = "bic",
               **fit_kwargs):
    """Fit every k in k_range and return (best_fit, best_k, scores) by
    BIC (default) or AIC — the mixture-order analogue of the rank
    selectors in ops/rank_select."""
    if criterion not in ("bic", "aic"):
        raise ValueError(f"criterion must be 'bic' or 'aic', got "
                         f"{criterion!r}")
    scores = {}
    best = None
    for k in k_range:
        fit = gmm_fit(x, int(k), key=key, **fit_kwargs)
        s = fit.bic() if criterion == "bic" else fit.aic()
        scores[int(k)] = s
        if best is None or s < scores[best[1]]:
            best = (fit, int(k))
    return best[0], best[1], scores

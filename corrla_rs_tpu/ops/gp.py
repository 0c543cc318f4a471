"""Gaussian-process regression (extension).

The reference README lists GP regression as a TODO it never implemented
(readme.md:34; SURVEY.md §2.4 item 5). This module completes that roadmap
item natively on the accelerator: exact GP with RBF / Matern-5/2 kernels, Cholesky solves
as dense matmuls, and marginal-likelihood hyperparameter optimization with exact
``jax.grad`` gradients (BFGS in log-parameter space).
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.scipy.optimize import minimize as _jsp_minimize

from corrla_rs_tpu.ops.interp import pairwise_dists
from corrla_rs_tpu.ops.mat_utils import PRECISION

__all__ = ["GpRegressor", "SparseGpRegressor", "gp_kernel_eval"]

_LOG_2PI = math.log(2.0 * math.pi)


def gp_kernel_eval(r: jnp.ndarray, kernel: str, length_scale, signal_var):
    """Stationary covariance k(r) for distance matrix r."""
    s = r / length_scale
    if kernel == "rbf":
        return signal_var * jnp.exp(-0.5 * s * s)
    if kernel == "matern52":
        c = jnp.sqrt(5.0) * s
        return signal_var * (1.0 + c + c * c / 3.0) * jnp.exp(-c)
    if kernel == "matern32":
        c = jnp.sqrt(3.0) * s
        return signal_var * (1.0 + c) * jnp.exp(-c)
    raise ValueError(f"unknown GP kernel: {kernel!r}")


def _jitter(dtype):
    # f32 Cholesky needs a larger floor: a near-noise-free MLE solution
    # leaves K within f32 rounding of singular (NaN Cholesky)
    return 1e-4 if dtype == jnp.float32 else 1e-6


def _masked_kernel_matrix(x, mask, kernel, ls, sv, nv):
    """Covariance with padded rows/cols replaced by identity: the pad
    block decouples EXACTLY (its Cholesky rows are e_i, its logdet
    contribution 0, its alpha entries y_pad = 0), so NLML and posterior
    over the valid points are bit-identical to the unpadded problem.
    Padding exists so growing datasets (Bayesian optimization, online
    fits) hit a few jit shapes instead of one per n."""
    n = x.shape[0]
    k = gp_kernel_eval(pairwise_dists(x, x), kernel, ls, sv)
    k = k + (nv + _jitter(x.dtype) * sv) * jnp.eye(n, dtype=x.dtype)
    if mask is None:
        return k
    m = mask.astype(x.dtype)
    return m[:, None] * k * m[None, :] + jnp.diag(1.0 - m)


@functools.partial(jax.jit, static_argnames=("kernel",))
def _nlml(log_params, x, y, kernel, mask=None):
    """Negative log marginal likelihood in log-parameter space."""
    ls, sv, nv = jnp.exp(log_params)
    k = _masked_kernel_matrix(x, mask, kernel, ls, sv, nv)
    n_eff = x.shape[0] if mask is None else jnp.sum(mask)
    if mask is not None:
        y = y * mask.astype(y.dtype)
    chol = jnp.linalg.cholesky(k)
    alpha = jax.scipy.linalg.cho_solve((chol, True), y)
    data_fit = 0.5 * jnp.sum(y * alpha)
    log_det = jnp.sum(jnp.log(jnp.diagonal(chol)))
    return (data_fit + log_det + 0.5 * n_eff * _LOG_2PI) / n_eff


@functools.partial(jax.jit, static_argnames=("kernel",))
def _gp_fit(x, y, log_params, kernel, mask=None):
    ls, sv, nv = jnp.exp(log_params)
    k = _masked_kernel_matrix(x, mask, kernel, ls, sv, nv)
    if mask is not None:
        y = y * mask.astype(y.dtype)
    chol = jnp.linalg.cholesky(k)
    alpha = jax.scipy.linalg.cho_solve((chol, True), y)
    return chol, alpha


@functools.partial(jax.jit, static_argnames=("kernel",))
def _gp_predict(x_train, chol, alpha, log_params, xq, kernel, mask=None):
    ls, sv, _nv = jnp.exp(log_params)
    k_q = gp_kernel_eval(pairwise_dists(xq, x_train), kernel, ls, sv)
    if mask is not None:
        k_q = k_q * mask.astype(k_q.dtype)[None, :]
    mean = jnp.matmul(k_q, alpha, precision=PRECISION)
    v = jax.scipy.linalg.solve_triangular(chol, k_q.T, lower=True)
    var = sv - jnp.sum(v * v, axis=0)
    return mean, jnp.maximum(var, 0.0)


class GpRegressor:
    """Exact GP regression with optional hyperparameter MLE.

    y is centered internally. predict returns (mean, var) with var the
    latent-function variance (add ``noise_var`` for observation variance).
    """

    def __init__(self, kernel: str = "rbf", length_scale: float = 1.0,
                 signal_var: float = 1.0, noise_var: float = 1e-4):
        self.kernel = kernel
        self.length_scale = float(length_scale)
        self.signal_var = float(signal_var)
        self.noise_var = float(noise_var)
        self.x_train = None

    def _log_params(self):
        return jnp.log(jnp.asarray(
            [self.length_scale, self.signal_var, self.noise_var]
        ))

    def fit(self, x, y, optimize_hypers: bool = True,
            pad_to: int | None = None):
        """Fit on (x, y). ``pad_to``: pad the training set to this size
        with exactly-masked rows — the posterior and NLML are identical
        to the unpadded fit (identity-row decoupling, see
        _masked_kernel_matrix), but jit sees one shape per bucket
        instead of one per n. Use for growing datasets (Bayesian
        optimization, online refits)."""
        x = jnp.asarray(x)
        y = jnp.asarray(y)
        if y.ndim == 2:
            y = y[:, 0]
        self._y_mean = jnp.mean(y)
        yc = y - self._y_mean
        mask = None
        if pad_to is not None:
            n = x.shape[0]
            if pad_to < n:
                raise ValueError(f"pad_to={pad_to} < n={n}")
            pad = int(pad_to) - n
            x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:],
                                              x.dtype)])
            yc = jnp.concatenate([yc, jnp.zeros((pad,), yc.dtype)])
            mask = jnp.concatenate([jnp.ones((n,), x.dtype),
                                    jnp.zeros((pad,), x.dtype)])
        if optimize_hypers:
            res = _jsp_minimize(
                lambda lp: _nlml(lp, x, yc, self.kernel, mask),
                self._log_params(), method="BFGS",
            )
            good = jnp.all(jnp.isfinite(res.x))
            lp = jnp.where(good, res.x, self._log_params())
            self.length_scale, self.signal_var, self.noise_var = (
                float(v) for v in jnp.exp(lp)
            )
        self.x_train = x
        self._yc = yc
        self._mask = mask
        self._chol, self._alpha = _gp_fit(x, yc, self._log_params(),
                                          self.kernel, mask)
        return self

    def predict(self, xq, return_var: bool = True):
        xq = jnp.asarray(xq)
        mean, var = _gp_predict(
            self.x_train, self._chol, self._alpha, self._log_params(), xq,
            self.kernel, getattr(self, "_mask", None),
        )
        mean = mean + self._y_mean
        return (mean, var) if return_var else mean

    def predict_cov(self, xq):
        """Full posterior covariance at the query points (n_q, n_q) —
        ``predict`` returns only its diagonal. Needed for coherent
        function draws and joint credible statements."""
        xq = jnp.asarray(xq)
        ls, sv, _nv = jnp.exp(self._log_params())
        k_q = gp_kernel_eval(pairwise_dists(xq, self.x_train),
                             self.kernel, ls, sv)
        mask = getattr(self, "_mask", None)
        if mask is not None:
            k_q = k_q * mask.astype(k_q.dtype)[None, :]
        k_qq = gp_kernel_eval(pairwise_dists(xq, xq), self.kernel, ls, sv)
        v = jax.scipy.linalg.solve_triangular(self._chol, k_q.T,
                                              lower=True)
        cov = k_qq - jnp.matmul(v.T, v, precision=PRECISION)
        return 0.5 * (cov + cov.T)

    def sample_posterior(self, xq, n_samples: int, key=0):
        """(n_samples, n_q) coherent posterior function draws at xq —
        unlike independent per-point draws from ``predict``'s variance,
        these respect the posterior correlations between query points."""
        from corrla_rs_tpu.utils.prng import as_key

        xq = jnp.asarray(xq)
        mean = self.predict(xq, return_var=False)
        cov = self.predict_cov(xq)
        # posterior cov can be numerically semidefinite: jitter the chol,
        # scaled to the ACTUAL covariance magnitude (a fixed floor would
        # inject independent noise that swamps well-constrained
        # posteriors whose true variances are tiny)
        n_q = cov.shape[0]
        scale = jnp.maximum(jnp.max(jnp.diagonal(cov)),
                            jnp.finfo(cov.dtype).tiny)
        chol = jnp.linalg.cholesky(
            cov + _jitter(cov.dtype) * scale
            * jnp.eye(n_q, dtype=cov.dtype))
        z = jax.random.normal(as_key(key), (int(n_samples), n_q),
                              cov.dtype)
        return mean[None, :] + z @ chol.T

    def log_marginal_likelihood(self) -> float:
        mask = getattr(self, "_mask", None)
        n = (self.x_train.shape[0] if mask is None
             else float(jnp.sum(mask)))
        return -float(_nlml(self._log_params(), self.x_train, self._yc,
                            self.kernel, mask)) * n


# ---------------------------------------------------------------------------
# Sparse GP (inducing points) for large N
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("kernel",))
def _sgpr_factors(x, y, x_ind, log_params, kernel):
    """Titsias (2009) variational sparse GP factors.

    Returns (l_mm, l_b, a, c) with
      l_mm = chol(K_mm + jitter), a = l_mm^-1 K_mn / sigma,
      l_b = chol(I + a a^T),      c = l_b^-1 a y / sigma,
    everything O(n m^2) and matmul-shaped. The ``a`` factor is
    returned because the ELBO's trace term needs sum(a*a) (see _sgpr_nlml).
    """
    ls, sv, nv = jnp.exp(log_params)
    m = x_ind.shape[0]
    sigma = jnp.sqrt(nv)
    k_mm = gp_kernel_eval(pairwise_dists(x_ind, x_ind), kernel, ls, sv)
    k_mm = k_mm + _jitter(x.dtype) * sv * jnp.eye(m, dtype=x.dtype)
    l_mm = jnp.linalg.cholesky(k_mm)
    k_mn = gp_kernel_eval(pairwise_dists(x_ind, x), kernel, ls, sv)
    a = jax.scipy.linalg.solve_triangular(l_mm, k_mn, lower=True) / sigma
    # chol(B) with B = I + A A^T via QR of [A^T; I] (R^T R = B): forming
    # the square would double the condition number — at n ~ 1e5, f32
    # Cholesky of the explicit B fails (cond ~ 1e7 observed) while the QR
    # route is exact at cond ~ 3e3
    stack = jnp.concatenate([a.T, jnp.eye(m, dtype=x.dtype)], axis=0)
    r = jnp.linalg.qr(stack, mode="r")
    sgn = jnp.sign(jnp.diagonal(r))
    sgn = jnp.where(sgn == 0, 1.0, sgn)
    l_b = (r * sgn[:, None]).T
    c = jax.scipy.linalg.solve_triangular(
        l_b, jnp.matmul(a, y, precision=PRECISION), lower=True
    ) / sigma
    return l_mm, l_b, a, c


@functools.partial(jax.jit, static_argnames=("kernel",))
def _sgpr_neg_elbo(log_params, x, y, x_ind, kernel):
    """Negative Titsias ELBO / n — the sparse analogue of _nlml; exact
    jax.grad gradients drive the same BFGS loop."""
    ls, sv, nv = jnp.exp(log_params)
    n = x.shape[0]
    _l_mm, l_b, a, c = _sgpr_factors(x, y, x_ind, log_params, kernel)
    quad = jnp.sum(y * y) / nv - jnp.sum(c * c)
    logdet = n * jnp.log(nv) + 2.0 * jnp.sum(jnp.log(jnp.diagonal(l_b)))
    trace = (n * sv - nv * jnp.sum(a * a)) / nv
    return 0.5 * (n * _LOG_2PI + logdet + quad + trace) / n


@functools.partial(jax.jit, static_argnames=("kernel",))
def _sgpr_predict(x_ind, l_mm, l_b, c, log_params, xq, kernel):
    ls, sv, _nv = jnp.exp(log_params)
    k_mq = gp_kernel_eval(pairwise_dists(x_ind, xq), kernel, ls, sv)
    a_q = jax.scipy.linalg.solve_triangular(l_mm, k_mq, lower=True)
    b_q = jax.scipy.linalg.solve_triangular(l_b, a_q, lower=True)
    mean = jnp.matmul(b_q.T, c, precision=PRECISION)
    var = sv - jnp.sum(a_q * a_q, axis=0) + jnp.sum(b_q * b_q, axis=0)
    return mean, jnp.maximum(var, 0.0)


class SparseGpRegressor:
    """Sparse variational GP (Titsias 2009 SGPR) for large training sets.

    EXTENSION beyond the exact ``GpRegressor``: m inducing points make
    fitting O(n m^2) and prediction O(m^2) instead of O(n^3)/O(n^2) —
    the production path when n reaches 10^4-10^6. Hyperparameters
    optimize the collapsed variational ELBO (a lower bound on the exact
    marginal likelihood; the variance term penalizes what the inducing
    set cannot explain) with exact jax.grad gradients, mirroring the
    exact GP's BFGS loop. Predictive mean/variance are the standard
    SGPR forms — variance correctly inflates away from inducing points.

    inducing: int (that many training points, chosen uniformly at random
    with ``key``) or an (m, d) array of explicit locations.
    """

    # class-level defaults: checkpoints written before these attributes
    # existed restore via cls.__new__ (no __init__); _y_scale = 1.0
    # reproduces the pre-standardization pipeline and _init_spec matches
    # the constructor defaults so a refit still works
    _y_scale = 1.0
    _init_spec = (1.0, 1.0, 1e-2)

    def __init__(self, kernel: str = "rbf", length_scale: float = 1.0,
                 signal_var: float = 1.0, noise_var: float = 1e-2,
                 inducing=128, key=0):
        self.kernel = kernel
        self.length_scale = float(length_scale)
        self.signal_var = float(signal_var)
        self.noise_var = float(noise_var)
        # the constructor values double as the (standardized-space) BFGS
        # init — kept separately so every fit restarts from the SAME spec
        # (re-using the raw-unit fitted attributes as init compounded by
        # var(y) per refit; caught in review)
        self._init_spec = (
            float(length_scale), float(signal_var), float(noise_var)
        )
        self._inducing_spec = inducing
        self._key = key
        self.x_ind = None

    def _log_params_std(self):
        """Hyperparameters in STANDARDIZED-y units (the internal fit
        space): variances scale with y^2, the length scale does not.
        Public attributes stay in raw-y units."""
        s2 = float(self._y_scale) ** 2
        return jnp.log(jnp.asarray(
            [self.length_scale, self.signal_var / s2, self.noise_var / s2]
        ))

    def fit(self, x, y, optimize_hypers: bool = True):
        from corrla_rs_tpu.utils.prng import as_key

        x = jnp.asarray(x)
        y = jnp.asarray(y)
        if y.ndim == 2:
            y = y[:, 0]
        self._y_mean = jnp.mean(y)
        # standardize y for the fit: the ELBO has a degenerate optimum at
        # signal_var -> 0 ("it's all noise") that BFGS falls into when the
        # kernel init is mis-scaled relative to var(y) (observed on
        # variance-14 data with the unit default). Fitting on unit-variance
        # targets keeps any reasonable init in the right basin; the user's
        # variances are converted into the standardized space and back, so
        # optimize_hypers=False reproduces the exact raw-units model.
        self._y_scale = jnp.maximum(
            jnp.std(y), jnp.asarray(jnp.finfo(y.dtype).tiny, y.dtype)
        )
        yc = (y - self._y_mean) / self._y_scale
        if isinstance(self._inducing_spec, int):
            m = min(self._inducing_spec, x.shape[0])
            idx = jax.random.choice(
                as_key(self._key), x.shape[0], (m,), replace=False
            )
            self.x_ind = x[idx]
        else:
            self.x_ind = jnp.asarray(self._inducing_spec)
        if optimize_hypers:
            # the BFGS START interprets the CONSTRUCTOR's variances in the
            # STANDARDIZED space (so the unit defaults mean "signal_var ~
            # var(y)" — the robust basin); fitted values are stored in raw
            # units and refits restart from the same constructor spec.
            # With optimize_hypers=False the constructor's values are raw
            # units, exactly as for GpRegressor.
            init = jnp.log(jnp.asarray(self._init_spec))
            res = _jsp_minimize(
                lambda lp: _sgpr_neg_elbo(lp, x, yc, self.x_ind,
                                          self.kernel),
                init, method="BFGS",
            )
            good = jnp.all(jnp.isfinite(res.x))
            lp = jnp.where(good, res.x, init)
            s2 = float(self._y_scale) ** 2
            ls, sv, nv = (float(v) for v in jnp.exp(lp))
            self.length_scale = ls
            self.signal_var = sv * s2
            self.noise_var = nv * s2
        self._yc = yc
        self.x_train = x
        l_mm, l_b, _a, c = _sgpr_factors(
            x, yc, self.x_ind, self._log_params_std(), self.kernel
        )
        self._l_mm, self._l_b, self._c = l_mm, l_b, c
        return self

    def predict(self, xq, return_var: bool = True):
        xq = jnp.asarray(xq)
        mean, var = _sgpr_predict(
            self.x_ind, self._l_mm, self._l_b, self._c,
            self._log_params_std(), xq, self.kernel,
        )
        mean = mean * self._y_scale + self._y_mean
        var = var * self._y_scale ** 2
        return (mean, var) if return_var else mean

    def elbo(self) -> float:
        """Collapsed variational lower bound on log p(y_standardized)
        (total, not /n; the fit-space objective)."""
        n = self.x_train.shape[0]
        return -float(_sgpr_neg_elbo(
            self._log_params_std(), self.x_train, self._yc, self.x_ind,
            self.kernel,
        )) * n

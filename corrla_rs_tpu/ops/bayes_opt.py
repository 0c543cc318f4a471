"""Bayesian optimization on the library's GP surrogate — EXTENSION.

The reference's only optimizers are MLE fitters for its own RV classes
(univariate_rv.rs / argmin); it has nothing for optimizing an EXPENSIVE
BLACK BOX — the canonical outer-loop task of the UQ workflows this
library serves (calibration, design, inverse problems). This module
composes pieces that already exist (ops/gp.GpRegressor surrogate,
ops/design space-filling candidates) into sample-efficient global
minimization (Jones-Schonlau-Welch EGO / Snoek 2012):

- acquisitions in closed form for minimization: expected improvement
  (EI), lower confidence bound (LCB), probability of improvement (PI);
- candidate search: scrambled-Sobol batch scored in ONE vmapped GP
  predict (accelerator-friendly: thousands of candidates per dispatch), then a
  few projected-gradient ascent steps on the acquisition from the best
  candidates — ``jax.grad`` flows through the GP posterior for free;
- ask/tell interface plus a ``minimize`` driver.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.design import latin_hypercube, sobol_sample
from corrla_rs_tpu.ops.gp import GpRegressor
from corrla_rs_tpu.utils.prng import as_key

__all__ = ["BayesOptResult", "expected_improvement", "lower_confidence_bound",
           "probability_of_improvement", "BayesOpt", "bayes_opt_minimize"]

_SQRT2 = 1.4142135623730951


def _norm_cdf(z):
    return 0.5 * (1.0 + jax.scipy.special.erf(z / _SQRT2))


def _norm_pdf(z):
    return jnp.exp(-0.5 * z * z) / jnp.sqrt(2.0 * jnp.pi)


def expected_improvement(mean, var, best, xi: float = 0.01):
    """EI for MINIMIZATION: E[max(best - xi - f, 0)] under N(mean, var)."""
    sd = jnp.sqrt(jnp.maximum(var, 1e-18))
    imp = best - xi - mean
    z = imp / sd
    return imp * _norm_cdf(z) + sd * _norm_pdf(z)


def lower_confidence_bound(mean, var, kappa: float = 2.0):
    """Negated LCB (higher = better) so every acquisition is maximized."""
    return -(mean - kappa * jnp.sqrt(jnp.maximum(var, 1e-18)))


def probability_of_improvement(mean, var, best, xi: float = 0.01):
    sd = jnp.sqrt(jnp.maximum(var, 1e-18))
    return _norm_cdf((best - xi - mean) / sd)


class BayesOptResult(NamedTuple):
    x_best: jnp.ndarray      # (d,) best observed input
    y_best: float            # best observed value
    x_hist: jnp.ndarray      # (n, d) all evaluated inputs
    y_hist: jnp.ndarray      # (n,) all observed values
    n_evals: int


class BayesOpt:
    """ask/tell Bayesian minimization over a box.

    bounds: (d, 2) [lo, hi] rows. The GP is refit (with hyperparameter
    MLE) on every ``ask``; observations are internally scored on
    z-normalized y so acquisition constants (xi, kappa) are scale-free.
    """

    def __init__(self, bounds, kernel: str = "rbf",
                 acquisition: str = "ei", xi: float = 0.01,
                 kappa: float = 2.0, noise_var: float = 1e-6,
                 n_candidates: int = 2048, n_grad_steps: int = 25,
                 key=0):
        self.bounds = np.asarray(bounds, np.float64)
        if self.bounds.ndim != 2 or self.bounds.shape[1] != 2:
            raise ValueError(f"bounds must be (d, 2), got "
                             f"{self.bounds.shape}")
        if acquisition not in ("ei", "lcb", "pi", "variance"):
            raise ValueError(f"unknown acquisition {acquisition!r}")
        self.kernel = kernel
        self.acquisition = acquisition
        self.xi = float(xi)
        self.kappa = float(kappa)
        self.noise_var = float(noise_var)
        self.n_candidates = int(n_candidates)
        self.n_grad_steps = int(n_grad_steps)
        self._key = as_key(key)
        self._x: list = []
        self._y: list = []

    # -- observations ------------------------------------------------
    def tell(self, x, y):
        x = np.atleast_2d(np.asarray(x, np.float64))
        y = np.atleast_1d(np.asarray(y, np.float64))
        if x.shape[0] != y.shape[0]:
            raise ValueError("x and y must have matching leading dims")
        self._x.extend(list(x))
        self._y.extend(list(y))
        return self

    @property
    def x_observed(self):
        return np.asarray(self._x)

    @property
    def y_observed(self):
        return np.asarray(self._y)

    def _acq_fn(self, gp, best_z):
        if self.acquisition == "ei":
            def acq(xq):
                m, v = gp.predict(xq)
                return expected_improvement(m, v, best_z, self.xi)
        elif self.acquisition == "pi":
            def acq(xq):
                m, v = gp.predict(xq)
                return probability_of_improvement(m, v, best_z, self.xi)
        elif self.acquisition == "variance":
            # pure exploration (active learning / sequential surrogate
            # design): maximize posterior uncertainty, ignore the mean
            def acq(xq):
                _m, v = gp.predict(xq)
                return jnp.sqrt(jnp.maximum(v, 1e-18))
        else:
            def acq(xq):
                m, v = gp.predict(xq)
                return lower_confidence_bound(m, v, self.kappa)
        return acq

    def ask(self, n_points: int = 1):
        """Next point(s) to evaluate. Requires >= 2 observations (use a
        space-filling initial design — see bayes_opt_minimize)."""
        if len(self._y) < 2:
            raise ValueError("tell() at least 2 observations before ask()")
        x = jnp.asarray(self.x_observed)
        y = np.asarray(self._y)
        mu, sd = float(y.mean()), float(y.std() + 1e-12)
        yz = jnp.asarray((y - mu) / sd)
        gp = GpRegressor(kernel=self.kernel, noise_var=self.noise_var)
        # power-of-two padded fit: exact (masked identity rows), and jit
        # compiles one BFGS program per BUCKET instead of one per n —
        # measured 3 s/iteration of XLA:CPU compile otherwise
        n = x.shape[0]
        pad_to = max(16, 1 << (int(n - 1).bit_length()))
        gp.fit(x, yz, optimize_hypers=True, pad_to=pad_to)
        best_z = float(jnp.min(yz))
        acq = self._acq_fn(gp, best_z)

        self._key, k_cand = jax.random.split(self._key)
        cands = jnp.asarray(sobol_sample(self.bounds, self.n_candidates,
                                         key=k_cand))
        # exploit around the incumbent too: local Gaussian perturbations
        self._key, k_loc = jax.random.split(self._key)
        width = jnp.asarray(self.bounds[:, 1] - self.bounds[:, 0])
        x_inc = x[int(jnp.argmin(yz))]
        local = x_inc + 0.05 * width * jax.random.normal(
            k_loc, (max(self.n_candidates // 8, 8), x.shape[1]))
        lo = jnp.asarray(self.bounds[:, 0])
        hi = jnp.asarray(self.bounds[:, 1])
        cands = jnp.concatenate([cands, jnp.clip(local, lo, hi)])

        scores = acq(cands)
        order = jnp.argsort(-scores)
        starts = cands[order[: max(4 * n_points, 8)]]

        # projected gradient ascent on the acquisition (sum over the
        # batch: starts are independent, so the batched gradient is the
        # per-start gradient)
        step = 0.05 * width

        def refine(xs):
            g = jax.grad(lambda z: jnp.sum(acq(z)))
            def body(_, cur):
                cur = cur + step * g(cur)
                return jnp.clip(cur, lo, hi)
            return jax.lax.fori_loop(0, self.n_grad_steps, body, xs)

        refined = refine(starts)
        all_pts = jnp.concatenate([starts, refined])
        all_scores = acq(all_pts)
        best_order = jnp.argsort(-all_scores)
        picked = []
        seen = []
        min_sep = 1e-9
        for idx in np.asarray(best_order):
            pt = all_pts[int(idx)]
            if any(float(jnp.max(jnp.abs(pt - s) / width)) < min_sep
                   for s in seen):
                continue
            picked.append(pt)
            seen.append(pt)
            if len(picked) == n_points:
                break
        out = jnp.stack(picked)
        return out[0] if n_points == 1 else out


def bayes_opt_minimize(fn: Callable, bounds, n_init: int = 8,
                       n_iters: int = 30, key=0,
                       **bo_kwargs) -> BayesOptResult:
    """Minimize a black-box ``fn(x) -> float`` over a box.

    fn receives a (d,) point (vmap/jit inside it if evaluations batch).
    n_init: LHS initial design size; n_iters: sequential BO evaluations.
    Extra kwargs go to :class:`BayesOpt` (acquisition=, kernel=, ...).
    """
    key = as_key(key)
    k_init, k_bo = jax.random.split(key)
    bo = BayesOpt(bounds, key=k_bo, **bo_kwargs)
    x0 = np.asarray(latin_hypercube(bo.bounds, int(n_init), key=k_init))
    y0 = [float(fn(jnp.asarray(p))) for p in x0]
    bo.tell(x0, y0)
    for _ in range(int(n_iters)):
        x_next = bo.ask()
        bo.tell(np.asarray(x_next)[None], [float(fn(x_next))])
    y = bo.y_observed
    i = int(np.argmin(y))
    return BayesOptResult(
        x_best=jnp.asarray(bo.x_observed[i]),
        y_best=float(y[i]),
        x_hist=jnp.asarray(bo.x_observed),
        y_hist=jnp.asarray(y),
        n_evals=len(y),
    )

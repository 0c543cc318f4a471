"""SINDy: sparse identification of nonlinear dynamics — EXTENSION.

The reference's system-identification family is LINEAR: DMDc fits
x_{k+1} = A x_k + B u_k (dmd_rom.rs:64-109) and can only represent
nonlinear dynamics through their best linear (or Koopman-lifted, see
models/edmd.py) approximation. SINDy (Brunton, Proctor & Kutz, PNAS
2016) identifies the GOVERNING EQUATIONS themselves: it regresses the
state derivative onto a library of candidate nonlinear features
Theta(x) and sparsifies the coefficient matrix with sequentially
thresholded least squares (STLSQ), recovering e.g. the Lorenz-63
right-hand side exactly from trajectory data. With a control input the
library is built over (x, u) — SINDYc (Brunton et al. 2016b) — the
nonlinear sibling of the reference's DMDc.

Accelerator shape:
- the feature library is ONE batched power-product: all monomial
  exponent tuples are enumerated at trace time and evaluated as
  ``prod(x[:, None, :] ** E[None])`` — a single fused elementwise
  kernel, no per-feature Python loop at run time;
- STLSQ runs as a ``lax.fori_loop`` over a FIXED number of sweeps with
  a per-target active mask. The masked solve keeps static shapes by
  substituting identity rows/cols for inactive features
  (A = M G M + (I - M), b' = M b) instead of shrinking the system —
  condition-safe in f32, exact zeros for pruned features;
- each sweep solves all d_out targets in one ``vmap``;
- forecasting integrates the identified ODE with a fixed-step RK4
  under ``lax.scan`` (discrete-time models iterate the map directly).
"""
from __future__ import annotations

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from corrla_rs_tpu.ops.mat_utils import PRECISION, fd_derivative as _fd_derivative
from corrla_rs_tpu.utils.checkpoint import register_model_class

__all__ = ["Sindy", "polynomial_exponents", "evaluate_library"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


def polynomial_exponents(n_dim: int, degree: int,
                         include_bias: bool = True) -> np.ndarray:
    """All monomial exponent tuples over ``n_dim`` variables up to
    ``degree``, graded-lexicographic. Returns an int array (n_feat, n_dim);
    row 0 is the bias (all zeros) when ``include_bias``.
    """
    rows = []
    lo = 0 if include_bias else 1
    for deg in range(lo, degree + 1):
        # multisets of size deg over n_dim variables
        for combo in itertools.combinations_with_replacement(
                range(n_dim), deg):
            e = np.zeros(n_dim, dtype=np.int32)
            for i in combo:
                e[i] += 1
            rows.append(e)
    if not rows:
        raise ValueError("empty feature library (degree < 1 and no bias)")
    return np.stack(rows)


def evaluate_library(x, exponents, trig_freqs: int = 0):
    """Theta(x): monomial features (+ optional sin/cos harmonics).

    x (n, d) -> (n, n_feat [+ 2*trig_freqs*d]). One batched power-product;
    ``where``-guarded so 0**0 == 1 exactly with zero gradient surprises.
    """
    e = jnp.asarray(exponents, dtype=x.dtype)          # (f, d)
    xb = x[:, None, :]                                  # (n, 1, d)
    # x**0 -> 1 without evaluating pow at 0. The where must guard the
    # INPUT as well as the output: d/dx x**0 = 0 * x**-1 is NaN at x = 0
    # and a where on the output alone lets the NaN through the VJP
    xb_safe = jnp.where(e[None] == 0, 1.0, xb)
    pw = jnp.where(e[None] == 0, 1.0, xb_safe ** e[None])  # (n, f, d)
    theta = jnp.prod(pw, axis=-1)                       # (n, f)
    if trig_freqs:
        ks = jnp.arange(1, trig_freqs + 1, dtype=x.dtype)
        ang = x[:, None, :] * ks[None, :, None]         # (n, K, d)
        ang = ang.reshape(x.shape[0], -1)
        theta = jnp.concatenate(
            [theta, jnp.sin(ang), jnp.cos(ang)], axis=1)
    return theta


@functools.partial(jax.jit, static_argnames=("n_sweeps",))
def _stlsq(theta, y, threshold, ridge, n_sweeps):
    """Sequentially thresholded least squares with per-target masks.

    theta (n, f), y (n, d_out) -> (w (f, d_out), mask (f, d_out) bool).
    Normal-equation form: G = Theta^T Theta is (f, f) regardless of n, so
    the per-sweep cost is independent of the trajectory length.
    """
    f = theta.shape[1]
    g = _mm(theta.T, theta)                 # (f, f)
    b = _mm(theta.T, y)                     # (f, d_out)
    eye = jnp.eye(f, dtype=theta.dtype)

    def solve_masked(mask_col, b_col):
        m = mask_col.astype(theta.dtype)
        # inactive rows/cols replaced by identity => exact 0 coefficients
        a = m[:, None] * g * m[None, :] + (1.0 - m) * eye \
            + ridge * jnp.diag(m)
        return jnp.linalg.solve(a, m * b_col)

    vsolve = jax.vmap(solve_masked, in_axes=(1, 1), out_axes=1)

    def body(_, mask):
        w = vsolve(mask, b)
        return jnp.abs(w) >= threshold

    mask0 = jnp.ones(b.shape, dtype=bool)
    mask = lax.fori_loop(0, n_sweeps, body, mask0)
    w = vsolve(mask, b)
    # final consistency: features the last solve pushed under threshold
    # are reported active=False but keep their (tiny) value zeroed
    mask = jnp.abs(w) >= threshold
    return jnp.where(mask, w, 0.0), mask


def weak_test_functions(n_samples: int, n_windows: int,
                        window_frac: float = 0.2, poly_order: int = 4):
    """Compactly supported polynomial bump test functions for weak-form
    identification: phi(t) = ((t-a)(b-t))^p on K windows, zero at the
    ends (so integration by parts carries NO boundary terms). Returns
    (phi (K, n), dphi (K, n)) sampled on the trajectory grid (dphi in
    index units; multiply by 1/dt outside)."""
    n = int(n_samples)
    k = int(n_windows)
    w = max(int(window_frac * n), 2 * poly_order + 2)
    w = min(w, n - 1)
    if k > 1 and n - w - 1 < 1:
        raise ValueError(
            f"trajectory too short for weak-form windows: n={n} allows "
            f"only one distinct window of width {w} (the weak system "
            "would be rank-1); add samples or shrink window_frac/"
            "poly_order")
    starts = np.linspace(0, n - w - 1, k).astype(int)
    t = np.arange(n, dtype=np.float64)
    phi = np.zeros((k, n))
    dphi = np.zeros((k, n))
    p = poly_order
    for i, a in enumerate(starts):
        b = a + w
        mask = (t >= a) & (t <= b)
        u = t[mask]
        base = (u - a) * (b - u)
        phi[i, mask] = base ** p
        dphi[i, mask] = p * base ** (p - 1) * ((b - u) - (u - a))
        # normalize each row for balanced rows in the weak system
        scale = np.linalg.norm(phi[i])
        phi[i] /= scale
        dphi[i] /= scale
    return jnp.asarray(phi), jnp.asarray(dphi)


def _monomial_name(e, names):
    parts = []
    for i, p in enumerate(e):
        if p == 1:
            parts.append(names[i])
        elif p > 1:
            parts.append(f"{names[i]}^{int(p)}")
    return " ".join(parts) if parts else "1"


@register_model_class
class Sindy:
    """Sparse nonlinear system identification (SINDy / SINDYc).

    Parameters
    ----------
    degree : polynomial library degree (all monomials of total degree
        <= degree over the state — and control, if given).
    threshold : STLSQ sparsity threshold (coefficient magnitudes below it
        are pruned each sweep).
    ridge : Tikhonov regularization added to the ACTIVE block of the
        normal equations (STLSQ-ridge, as in PySINDy's STLSQ(alpha=...)).
    n_sweeps : fixed number of threshold/re-solve sweeps (static for jit).
    trig_freqs : adds sin(k x_i), cos(k x_i) for k = 1..trig_freqs.
    discrete : fit the map x_{k+1} = Theta(x_k) W instead of the ODE
        x_dot = Theta(x) W.

    After ``fit``: ``coefficients_`` (n_feat, d), ``mask_`` (bool, same
    shape), ``feature_names_`` (list of str), plus ``equations()`` /
    ``predict`` / ``simulate``. Checkpointable via utils.checkpoint.
    """

    def __init__(self, degree: int = 3, threshold: float = 0.1,
                 ridge: float = 1e-6, n_sweeps: int = 10,
                 include_bias: bool = True, trig_freqs: int = 0,
                 discrete: bool = False):
        self.degree = int(degree)
        self.threshold = float(threshold)
        self.ridge = float(ridge)
        self.n_sweeps = int(n_sweeps)
        self.include_bias = bool(include_bias)
        self.trig_freqs = int(trig_freqs)
        self.discrete = bool(discrete)
        self.n_dim = None
        self.n_control = 0
        self.coefficients_ = None
        self.mask_ = None
        self.feature_names_ = None
        self._exponents = None

    # -- fitting -----------------------------------------------------
    def fit(self, x, x_dot=None, u=None, dt: float = 1.0,
            weak: bool = False, n_windows: int = 100,
            window_frac: float = 0.2):
        """Identify dynamics from a trajectory.

        x (n, d): snapshots sampled every ``dt``.
        x_dot (n, d): optional analytic/precomputed derivatives
            (continuous-time only); finite-differenced from x otherwise.
        u (n, m): optional control inputs (SINDYc) — library features are
            built over (x, u), dynamics targets remain x.
        weak: WEAK-FORM identification (Messenger & Bortz 2021 WSINDy):
            instead of differentiating noisy data, integrate against
            compactly supported test functions phi — integration by
            parts turns x' phi into -x phi' (no boundary terms), so the
            DATA is never differentiated and measurement noise is
            averaged, not amplified. The regression becomes
            (phi Theta dt) W = -(phi' x): same STLSQ, K = ``n_windows``
            weak equations per state. Continuous-time only.
        """
        if weak:
            if self.discrete:
                raise ValueError("weak=True is continuous-time only")
            if x_dot is not None:
                raise ValueError("weak=True derives its own targets; "
                                 "x_dot is meaningless")
            return self._fit_weak(x, u, dt, n_windows, window_frac)
        x = jnp.atleast_2d(jnp.asarray(x))
        n, d = x.shape
        self.n_dim = d
        if self.discrete:
            if x_dot is not None:
                raise ValueError("x_dot is meaningless for discrete=True")
            y = x[1:]
            z = x[:-1]
            u_lib = None if u is None else jnp.asarray(u)[: n - 1]
        else:
            y = (jnp.asarray(x_dot) if x_dot is not None
                 else _fd_derivative(x, dt))
            z = x
            u_lib = None if u is None else jnp.asarray(u)
        if u_lib is not None:
            u_lib = jnp.atleast_2d(u_lib)
            if u_lib.shape[0] != z.shape[0]:
                raise ValueError(
                    f"u rows {u_lib.shape[0]} != state rows {z.shape[0]}")
            self.n_control = int(u_lib.shape[1])
            z = jnp.concatenate([z, u_lib], axis=1)
        else:
            self.n_control = 0

        expts = polynomial_exponents(
            d + self.n_control, self.degree, self.include_bias)
        self._exponents = jnp.asarray(expts)
        theta = evaluate_library(z, self._exponents, self.trig_freqs)
        w, mask = _stlsq(
            theta, y,
            jnp.asarray(self.threshold, theta.dtype),
            jnp.asarray(self.ridge, theta.dtype),
            self.n_sweeps,
        )
        self.coefficients_ = w
        self.mask_ = mask
        self.feature_names_ = self._make_names(expts, d)
        return self

    def _fit_weak(self, x, u, dt, n_windows, window_frac):
        x = jnp.atleast_2d(jnp.asarray(x))
        n, d = x.shape
        self.n_dim = d
        z = x
        if u is not None:
            u_lib = jnp.atleast_2d(jnp.asarray(u))
            if u_lib.shape[0] != n:
                raise ValueError(
                    f"u rows {u_lib.shape[0]} != state rows {n}")
            self.n_control = int(u_lib.shape[1])
            z = jnp.concatenate([x, u_lib], axis=1)
        else:
            self.n_control = 0
        expts = polynomial_exponents(
            d + self.n_control, self.degree, self.include_bias)
        self._exponents = jnp.asarray(expts)
        theta = evaluate_library(z, self._exponents, self.trig_freqs)
        phi, dphi = weak_test_functions(n, n_windows, window_frac)
        phi = phi.astype(theta.dtype)
        dphi = dphi.astype(theta.dtype)
        # weak system: (phi Theta) W dt = -(dphi/dt) x dt = -dphi x
        g = _mm(phi, theta) * dt                   # (K, f)
        b = -_mm(dphi, x)                          # (K, d)
        w, mask = _stlsq(
            g, b,
            jnp.asarray(self.threshold, theta.dtype),
            jnp.asarray(self.ridge, theta.dtype),
            self.n_sweeps,
        )
        self.coefficients_ = w
        self.mask_ = mask
        self.feature_names_ = self._make_names(expts, d)
        return self

    def _make_names(self, expts, d):
        names = [f"x{i}" for i in range(d)] + [
            f"u{j}" for j in range(self.n_control)]
        out = [_monomial_name(e, names) for e in expts]
        # evaluate_library emits ALL sin blocks (k-major, dim-minor),
        # then all cos blocks — names must match that column order
        ks = range(1, self.trig_freqs + 1)
        out += [f"sin({k} {nm})" for k in ks for nm in names]
        out += [f"cos({k} {nm})" for k in ks for nm in names]
        return out

    # -- evaluation --------------------------------------------------
    def _rhs(self, x, u=None):
        z = x if u is None else jnp.concatenate([x, u], axis=-1)
        th = evaluate_library(jnp.atleast_2d(z), self._exponents,
                              self.trig_freqs)
        out = _mm(th, self.coefficients_)
        return out[0] if z.ndim == 1 else out

    def predict(self, x, u=None):
        """x_dot (continuous) or x_next (discrete) at the given states."""
        if self.coefficients_ is None:
            raise ValueError("fit() first")
        if self.n_control and u is None:
            raise ValueError("model was fit with control; pass u")
        return self._rhs(jnp.asarray(x),
                         None if u is None else jnp.asarray(u))

    def simulate(self, x0, n_steps: int, dt: float = 1.0, u=None):
        """Roll the identified model forward: (n_steps + 1, d) trajectory
        including x0. Continuous models use fixed-step RK4; discrete
        models iterate the map. ``u`` (n_steps, m) is held constant over
        each step."""
        if self.coefficients_ is None:
            raise ValueError("fit() first")
        x0 = jnp.asarray(x0)
        if self.n_control:
            if u is None:
                raise ValueError("model was fit with control; pass u")
            u = jnp.asarray(u)
            if u.shape[0] < n_steps:
                raise ValueError(f"need u for {n_steps} steps, got "
                                 f"{u.shape[0]}")
            us = u[:n_steps]
        else:
            us = jnp.zeros((n_steps, 0), x0.dtype)

        if self.discrete:
            def step(xk, uk):
                xn = self._rhs(xk, uk if self.n_control else None)
                return xn, xn
        else:
            def step(xk, uk):
                uc = uk if self.n_control else None
                k1 = self._rhs(xk, uc)
                k2 = self._rhs(xk + 0.5 * dt * k1, uc)
                k3 = self._rhs(xk + 0.5 * dt * k2, uc)
                k4 = self._rhs(xk + dt * k3, uc)
                xn = xk + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
                return xn, xn

        _, traj = lax.scan(step, x0, us)
        return jnp.concatenate([x0[None], traj], axis=0)

    def score(self, x, x_dot=None, u=None, dt: float = 1.0):
        """R^2 of the derivative (or next-state) regression on held data."""
        x = jnp.atleast_2d(jnp.asarray(x))
        if self.discrete:
            y = x[1:]
            pred = self.predict(
                x[:-1], None if u is None else jnp.asarray(u)[:-1])
        else:
            y = (jnp.asarray(x_dot) if x_dot is not None
                 else _fd_derivative(x, dt))
            pred = self.predict(x, u)
        ss_res = jnp.sum((y - pred) ** 2)
        ss_tot = jnp.sum((y - jnp.mean(y, axis=0)) ** 2)
        return float(1.0 - ss_res / ss_tot)

    def equations(self, precision: int = 3):
        """Human-readable identified equations, one string per state dim."""
        if self.coefficients_ is None:
            raise ValueError("fit() first")
        w = np.asarray(self.coefficients_)
        lhs = ("x{i}[k+1]" if self.discrete else "d x{i}/dt")
        eqs = []
        for i in range(w.shape[1]):
            terms = [
                f"{w[j, i]:+.{precision}g} {self.feature_names_[j]}"
                for j in range(w.shape[0]) if w[j, i] != 0.0
            ]
            rhs = " ".join(terms) if terms else "0"
            eqs.append(f"{lhs.format(i=i)} = {rhs}")
        return eqs

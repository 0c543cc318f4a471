"""Operator inference (OpInf): non-intrusive projection-based ROMs —
EXTENSION.

The reference's ROM family is interpolatory (PodI, pod_rom.rs) or
linear-dynamics (DMDc, dmd_rom.rs): neither learns a NONLINEAR reduced
model. Operator inference (Peherstorfer & Willcox 2016, "Data-driven
operator inference for nonintrusive projection-based model reduction")
fits the canonical polynomial ROM form directly from snapshot data:

    d/dt xhat = c + A xhat + H kron2(xhat) + B u

where xhat = Vr^T x are POD coordinates and kron2 is the COMPRESSED
(unique-pair, r(r+1)/2-term) Kronecker square — the structure every
quadratic PDE (Burgers, Navier-Stokes, reaction-diffusion) has after
Galerkin projection, but learned from data with NO access to the
high-fidelity operators.

Fit = one regularized least squares over the data matrix
D = [1, Xhat^T, kron2(Xhat)^T, U^T]: the normal equations are formed
once as dense matmuls and solved per operator-block ridge (Tikhonov with
separate penalties for linear and quadratic blocks, as in McQuarrie-
Huang-Willcox 2021 — the quadratic block needs heavier damping under
noise). POD basis via the library's randomized SVD; rollouts are RK4
under ``lax.scan`` in the r-dimensional reduced space (cost independent
of n_x), lifted back through Vr.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from corrla_rs_tpu.ops.mat_utils import PRECISION, fd_derivative as _fd_derivative
from corrla_rs_tpu.ops.random_svd import random_svd
from corrla_rs_tpu.utils.checkpoint import register_model_class
from corrla_rs_tpu.utils.prng import as_key

__all__ = ["OpInf", "kron2_compressed"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


def _pair_indices(r: int):
    iu = np.triu_indices(r)
    return iu[0], iu[1]


def kron2_compressed(x):
    """Unique-pair quadratic features: for state(s) x (.., r) return
    (.., r(r+1)/2) with entries x_i x_j for i <= j. The compressed form
    keeps the regression full-rank (the full Kronecker square duplicates
    every cross term)."""
    r = x.shape[-1]
    ii, jj = _pair_indices(r)
    return x[..., ii] * x[..., jj]


@register_model_class
class OpInf:
    """Quadratic operator-inference ROM.

    Parameters
    ----------
    n_modes : reduced dimension r (POD basis size).
    reg_linear / reg_quadratic : Tikhonov penalties for the
        [c, A, B] columns and the H columns respectively.
    include_constant / include_quadratic : model-form flags.
    n_iters / n_oversamples : randomized-SVD parameters for the basis.

    fit(x, dt, x_dot=None, u=None): snapshots x are (n_t, n_x) rows =
    time samples (the library's snapshot layout); u (n_t, m) optional
    inputs. After fit: ``basis_`` (n_x, r), operators ``c_``, ``a_``,
    ``h_`` (r, r(r+1)/2), ``b_``.
    """

    def __init__(self, n_modes: int, reg_linear: float = 1e-8,
                 reg_quadratic: float = 1e-6, include_constant: bool = True,
                 include_quadratic: bool = True, n_iters: int = 10,
                 n_oversamples: int = 10):
        self.n_modes = int(n_modes)
        self.reg_linear = float(reg_linear)
        self.reg_quadratic = float(reg_quadratic)
        self.include_constant = bool(include_constant)
        self.include_quadratic = bool(include_quadratic)
        self.n_iters = int(n_iters)
        self.n_oversamples = int(n_oversamples)
        self.n_control = 0
        self.basis_ = None
        self.c_ = None
        self.a_ = None
        self.h_ = None
        self.b_ = None
        self.singular_values_ = None

    # -- fitting -----------------------------------------------------
    def fit(self, x, dt: float = 1.0, x_dot=None, u=None, key=0,
            basis=None):
        x = jnp.asarray(x)
        n_t, n_x = x.shape
        r = self.n_modes
        if basis is not None:
            vr = jnp.asarray(basis)
            if vr.shape != (n_x, r):
                raise ValueError(f"basis must be ({n_x}, {r}), got "
                                 f"{vr.shape}")
            s = None
        else:
            # snapshots are rows -> right singular vectors span state space
            _u_, s, vt = random_svd(x, r, self.n_iters, self.n_oversamples,
                                    key=as_key(key))
            vr = vt.T                               # (n_x, r)
        self.basis_ = vr
        self.singular_values_ = s
        xhat = _mm(x, vr)                           # (n_t, r)
        if x_dot is not None:
            xdot_hat = _mm(jnp.asarray(x_dot), vr)
        else:
            xdot_hat = _fd_derivative(xhat, dt)

        blocks = []
        regs = []
        if self.include_constant:
            blocks.append(jnp.ones((n_t, 1), x.dtype))
            regs.append(jnp.full((1,), self.reg_linear, x.dtype))
        blocks.append(xhat)
        regs.append(jnp.full((r,), self.reg_linear, x.dtype))
        if self.include_quadratic:
            q = kron2_compressed(xhat)
            blocks.append(q)
            regs.append(jnp.full((q.shape[1],), self.reg_quadratic,
                                 x.dtype))
        if u is not None:
            u = jnp.atleast_2d(jnp.asarray(u))
            if u.shape[0] != n_t:
                raise ValueError(f"u rows {u.shape[0]} != snapshots {n_t}")
            self.n_control = int(u.shape[1])
            blocks.append(u)
            regs.append(jnp.full((u.shape[1],), self.reg_linear, x.dtype))
        else:
            self.n_control = 0
        d = jnp.concatenate(blocks, axis=1)         # (n_t, p)
        lam = jnp.concatenate(regs)
        # per-column-block ridge: (D^T D + diag(lam^2)) O^T = D^T Xdot
        gram = _mm(d.T, d) + jnp.diag(lam ** 2)
        rhs = _mm(d.T, xdot_hat)
        ops = jnp.linalg.solve(gram, rhs).T          # (r, p)

        col = 0
        if self.include_constant:
            self.c_ = ops[:, 0]
            col = 1
        else:
            self.c_ = jnp.zeros((r,), x.dtype)
        self.a_ = ops[:, col: col + r]
        col += r
        if self.include_quadratic:
            nq = r * (r + 1) // 2
            self.h_ = ops[:, col: col + nq]
            col += nq
        else:
            self.h_ = jnp.zeros((r, r * (r + 1) // 2), x.dtype)
        self.b_ = (ops[:, col:] if self.n_control
                   else jnp.zeros((r, 0), x.dtype))
        return self

    # -- evaluation --------------------------------------------------
    def _rhs_reduced(self, xhat, u=None):
        out = self.c_ + _mm(self.a_, xhat[..., None])[..., 0] \
            + _mm(self.h_, kron2_compressed(xhat)[..., None])[..., 0]
        if self.n_control and u is not None:
            out = out + _mm(self.b_, u[..., None])[..., 0]
        return out

    def reduce(self, x):
        """Project full states (n, n_x) to reduced coordinates (n, r)."""
        return _mm(jnp.asarray(x), self.basis_)

    def lift(self, xhat):
        """Reduced coordinates back to the full space."""
        return _mm(jnp.asarray(xhat), self.basis_.T)

    def simulate_reduced(self, xhat0, n_steps: int, dt: float, u=None):
        """RK4 rollout in the reduced space: (n_steps + 1, r)."""
        if self.basis_ is None:
            raise ValueError("fit() first")
        xhat0 = jnp.asarray(xhat0)
        if self.n_control:
            if u is None:
                raise ValueError("model was fit with control; pass u")
            us = jnp.asarray(u)[:n_steps]
            if us.shape[0] < n_steps:
                raise ValueError(f"need u for {n_steps} steps")
        else:
            us = jnp.zeros((n_steps, 0), xhat0.dtype)

        def step(xk, uk):
            uc = uk if self.n_control else None
            k1 = self._rhs_reduced(xk, uc)
            k2 = self._rhs_reduced(xk + 0.5 * dt * k1, uc)
            k3 = self._rhs_reduced(xk + 0.5 * dt * k2, uc)
            k4 = self._rhs_reduced(xk + dt * k3, uc)
            xn = xk + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            return xn, xn

        _, traj = lax.scan(step, xhat0, us)
        return jnp.concatenate([xhat0[None], traj], axis=0)

    def predict(self, x0, n_steps: int, dt: float, u=None):
        """Full-space forecast from a full initial state: project,
        integrate the learned ROM, lift. (n_steps + 1, n_x)."""
        xhat0 = _mm(self.basis_.T, jnp.asarray(x0))
        traj = self.simulate_reduced(xhat0, n_steps, dt, u=u)
        return self.lift(traj)

"""Preconditioned conjugate gradient: batched, matrix-free — EXTENSION.

The library's direct solvers (Cholesky/LU/QR) need the operator densely;
its randomized ones (sketched_lstsq) target least squares. This module
adds the canonical ITERATIVE SPD solver so kernel systems, covariance
solves and Laplacian-like operators can be solved matrix-free at scales
where O(n^3)/O(n^2) storage is off the table — and pairs with
ops/slq.py (solves + logdet = full GP inference via matvecs only).

Accelerator shape: every RHS column advances in lockstep — one batched
(n, k) operator application per iteration (dense matmul for explicit
matrices), scalars per column via reductions, the loop a
``lax.fori_loop`` with a convergence MASK instead of early exit
(static shapes; converged columns freeze, so extra iterations are
numerically inert and cost only the shared matvec). Per-column
residual histories come back for diagnosis.

``jax.scipy.sparse.linalg.cg`` exists but runs a while_loop on a single
RHS pytree with host-driven tolerances; this implementation is batched,
fixed-shape (jit/vmap/scan-safe inside bigger programs), and returns
the residual trace.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from corrla_rs_tpu.ops.mat_utils import PRECISION, apply_operator as _apply

__all__ = ["CgResult", "cg_solve", "jacobi_preconditioner",
           "nystrom_preconditioner"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


class CgResult(NamedTuple):
    x: jnp.ndarray            # (n,) or (n, k) solution(s)
    residual_norms: jnp.ndarray  # (n_iters + 1, k) per-iteration ||r||_2
    converged: jnp.ndarray    # (k,) bool, ||r|| <= tol * ||b||
    n_iters: int


def jacobi_preconditioner(a) -> Callable:
    """Diagonal (Jacobi) preconditioner M^-1 v = v / diag(A) for an
    explicit matrix — the zero-thought default for diagonally dominant
    kernels."""
    d = jnp.diag(jnp.asarray(a))
    inv = jnp.where(d != 0, 1.0 / d, 1.0)

    def apply(v):
        return v * inv[:, None]

    return apply


def nystrom_preconditioner(a, rank: int, mu: float,
                           n_oversamples: int = 8, key=0) -> Callable:
    """Randomized Nystrom preconditioner for (A + mu I) x = b, A PSD
    (Frangella, Tropp & Udell 2023): one sketch of A gives a rank-r
    eigenapproximation U diag(lam) U^T, and

        P^-1 = U diag((lam_r + mu) / (lam + mu)) U^T + (I - U U^T)

    clusters the preconditioned spectrum near 1 wherever A's spectrum
    decays past ``rank`` — regularized kernel/covariance solves converge
    in O(1) CG iterations instead of O(sqrt(cond)). Pass the result as
    ``cg_solve(a_plus_mu, b, preconditioner=...)``; building it costs
    one (n, r) sketch matmul + one small eigh.
    """
    from corrla_rs_tpu.ops.nystrom import nystrom_eigh

    lam, u = nystrom_eigh(a, int(rank), n_oversamples=n_oversamples,
                          key=key)
    lam = jnp.maximum(lam, 0.0)
    scale = (lam[-1] + mu) / (lam + mu)          # (r,)

    def apply(v):
        utv = _mm(u.T, v)                         # (r, k)
        return v + _mm(u, (scale - 1.0)[:, None] * utv)

    return apply


def cg_solve(a, b, x0=None, n_iters: int = 100, tol: float = 1e-8,
             preconditioner: Callable | None = None) -> CgResult:
    """Solve A x = b for SPD A, batched over RHS columns.

    a : (n, n) SPD matrix or batched matvec callable (n, k) -> (n, k).
    b : (n,) or (n, k).
    preconditioner : optional callable v (n, k) -> M^-1 v (n, k)
        (see :func:`jacobi_preconditioner`).
    tol : relative residual target; converged columns freeze (mask), the
        loop itself always runs ``n_iters`` iterations (static shape).
    """
    b = jnp.asarray(b)
    vec = b.ndim == 1
    bb = b[:, None] if vec else b
    n, k = bb.shape
    dtype = bb.dtype
    if n_iters < 1:
        raise ValueError(f"n_iters must be >= 1, got {n_iters}")
    x = (jnp.zeros_like(bb) if x0 is None
         else (jnp.asarray(x0)[:, None] if vec else jnp.asarray(x0)))
    if x.shape != bb.shape:
        raise ValueError(f"x0 shape {x.shape} != b shape {bb.shape}")
    precond = preconditioner if preconditioner is not None else (
        lambda v: v)

    r = bb - _apply(a, x)
    z = precond(r)
    p = z
    rz = jnp.sum(r * z, axis=0)                      # (k,)
    b_norm = jnp.maximum(jnp.linalg.norm(bb, axis=0),
                         jnp.finfo(dtype).tiny)
    tiny = jnp.finfo(dtype).tiny

    def body(i, carry):
        x, r, z, p, rz, hist = carry
        r_norm = jnp.linalg.norm(r, axis=0)
        hist = hist.at[i].set(r_norm)
        active = (r_norm / b_norm) > tol             # (k,)
        ap = _apply(a, p)
        denom = jnp.sum(p * ap, axis=0)
        alpha = jnp.where(active, rz / jnp.where(
            jnp.abs(denom) > tiny, denom, 1.0), 0.0)
        x = x + alpha[None, :] * p
        r_new = r - alpha[None, :] * ap
        z_new = precond(r_new)
        rz_new = jnp.sum(r_new * z_new, axis=0)
        beta = jnp.where(active, rz_new / jnp.where(
            jnp.abs(rz) > tiny, rz, 1.0), 0.0)
        p = z_new + beta[None, :] * p
        return x, r_new, z_new, p, rz_new, hist

    hist0 = jnp.zeros((int(n_iters) + 1, k), dtype)
    x, r, _z, _p, _rz, hist = lax.fori_loop(
        0, int(n_iters), body, (x, r, z, p, rz, hist0))
    final_norm = jnp.linalg.norm(r, axis=0)
    hist = hist.at[int(n_iters)].set(final_norm)
    converged = (final_norm / b_norm) <= tol
    return CgResult(
        x=x[:, 0] if vec else x,
        residual_norms=hist,
        converged=converged[0] if vec else converged,
        n_iters=int(n_iters),
    )

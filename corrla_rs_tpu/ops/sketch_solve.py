"""Sketch-and-precondition least squares — EXTENSION (no reference
analogue; Blendenpik: Avron-Maymounkov-Toledo 2010, LSRN:
Meng-Saunders-Mahoney 2014).

The reference solves LS problems with dense QR/pinv at O(m n^2) host
flops. For the very tall systems this library targets (m >> n: RBF
weight solves over long sample axes, regression on streamed features),
the randomized recipe is asymptotically and practically faster on an
device: ONE sketch matmul S A (the only O(m n s) work, a dense matmul pass),
a QR of the small (s, n) sketch, and a short preconditioned CGLS loop
whose iterates each cost two more tall matmuls. With s ~= 4 n the
preconditioned system has condition number ~3 REGARDLESS of cond(A)
(Marchenko-Pastur: sqrt(cond) ~ (1+sqrt(n/s))/(1-sqrt(n/s))), so a
FIXED ~30-iteration lax.scan reaches f64 machine accuracy — no
data-dependent control flow inside jit.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.utils.prng import as_key

__all__ = ["sketched_lstsq"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


@functools.partial(jax.jit, static_argnames=("s_rows", "n_iters"))
def _sketched_cgls(a, b, s_rows, n_iters, key):
    """Preconditioned CGLS on min ||A x - b||_2.

    Precondition with R from QR(S A): substitute x = R^{-1} z and run
    CGLS on (A R^{-1}); every iterate applies R^{-1} / R^{-T} by
    triangular solves (n x n) and A / A^T by tall matmuls.
    Returns (x, normal-equation residual history (n_iters,))."""
    m, n = a.shape
    sk = jax.random.normal(key, (s_rows, m), dtype=a.dtype)
    sk = sk / jnp.sqrt(jnp.asarray(s_rows, a.dtype))
    _, r_mat = jnp.linalg.qr(_mm(sk, a))
    # guard rank deficiency: floor R's diagonal at eps * max|diag|
    eps = jnp.finfo(a.dtype).eps
    d = jnp.diagonal(r_mat)
    floor = eps * jnp.max(jnp.abs(d))
    sign = jnp.where(d < 0, -1.0, 1.0).astype(a.dtype)
    bump = sign * jnp.maximum(jnp.abs(d), floor)
    r_mat = r_mat.at[jnp.arange(n), jnp.arange(n)].set(bump)

    solve_r = functools.partial(
        jax.scipy.linalg.solve_triangular, r_mat, lower=False
    )
    solve_rt = functools.partial(
        jax.scipy.linalg.solve_triangular, r_mat.T, lower=True
    )

    def amat(z):          # A R^{-1} z
        return _mm(a, solve_r(z[:, None]))[:, 0]

    def atmat(y):         # R^{-T} A^T y
        return solve_rt(_mm(a.T, y[:, None]))[:, 0]

    z = jnp.zeros((n,), a.dtype)
    res = b
    g = atmat(res)
    p = g
    gg = jnp.vdot(g, g)

    # finite precision makes CGLS DIVERGE once it passes the attainable
    # accuracy (R carries cond(A); the triangular solves inject noise
    # the recurrence then amplifies) — so track the best iterate by
    # TRUE residual norm and return that: extra iterations are inert
    def step(carry, _):
        z, res, p, gg, z_best, rn_best = carry
        q = amat(p)
        alpha = gg / jnp.maximum(jnp.vdot(q, q), jnp.finfo(a.dtype).tiny)
        z = z + alpha * p
        res = res - alpha * q
        g = atmat(res)
        gg_new = jnp.vdot(g, g)
        beta = gg_new / jnp.maximum(gg, jnp.finfo(a.dtype).tiny)
        p = g + beta * p
        rn = jnp.linalg.norm(res)
        better = rn < rn_best
        z_best = jnp.where(better, z, z_best)
        rn_best = jnp.where(better, rn, rn_best)
        return (z, res, p, gg_new, z_best, rn_best), jnp.sqrt(gg_new)

    init = (z, res, p, gg, z, jnp.linalg.norm(res))
    (_, _, _, _, z_best, _), hist = jax.lax.scan(
        step, init, None, length=n_iters
    )
    return solve_r(z_best[:, None])[:, 0], hist


def sketched_lstsq(a, b, sketch_factor: float = 4.0, n_iters: int = 30,
                   key=0, mesh=None):
    """min_x ||A x - b||_2 by sketch-and-precondition CGLS.

    a: (m, n) with m >= n (very tall is the target regime); b: (m,) or
    (m, k) — multiple right-hand sides share the sketch/QR and solve
    column-by-column under vmap; sketch_factor: sketch rows = factor*n
    (>= 2; 4 keeps the preconditioned condition number ~3);
    n_iters: fixed CGLS iterations (30 reaches f64 machine precision
    at factor 4); mesh: optional 1-D jax.sharding.Mesh — A's rows (the
    long axis) shard across devices; every contraction over m (the
    sketch, A^T r) reduces with one psum under GSPMD while the small
    (s, n)/(n, n) algebra replicates.

    Returns (x, hist): the solution(s) (n,) or (n, k) and the
    preconditioned normal-residual history (n_iters,) or (k, n_iters)
    for convergence inspection.
    """
    a = jnp.asarray(a)
    if a.ndim != 2 or a.shape[0] < a.shape[1]:
        raise ValueError(
            f"a must be (m >= n, n) tall, got {np.shape(a)}"
        )
    m, n = int(a.shape[0]), int(a.shape[1])
    if sketch_factor < 2.0:
        raise ValueError(
            f"sketch_factor must be >= 2, got {sketch_factor}"
        )
    s_rows = min(max(int(round(sketch_factor * n)), n + 8), m)
    bb = jnp.asarray(b)
    squeeze = bb.ndim == 1
    if squeeze:
        bb = bb[:, None]
    if bb.shape[0] != m:
        raise ValueError(f"b must have {m} rows, got {bb.shape}")
    if mesh is not None:
        from corrla_rs_tpu.parallel.mesh import shard_rows

        a = shard_rows(a, mesh)
        bb = shard_rows(bb, mesh)
    else:
        from corrla_rs_tpu.utils.smallpath import maybe_route_small

        a, bb = maybe_route_small(a, bb)
    xs, hists = jax.vmap(
        lambda col: _sketched_cgls(a, col, s_rows, int(n_iters),
                                   as_key(key)),
        in_axes=1, out_axes=(1, 0),
    )(bb)
    if squeeze:
        return xs[:, 0], hists[0]
    return xs, hists

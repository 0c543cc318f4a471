"""Robust PCA (principal component pursuit) — EXTENSION (no reference
analogue; Candes-Li-Ma-Wright 2011, inexact-ALM solver of Lin-Chen-Ma
2010).

NOT the reference's ``rpca`` (that is RANDOMIZED PCA, which this
package mirrors under the same name). Robust PCA decomposes
M = L + S with L low-rank and S sparse by convex relaxation:

    min ||L||_* + lambda ||S||_1   s.t.  L + S = M,

which provably recovers both factors exactly when the corruption is
sparse enough — the standard tool for gross outliers, sensor glitches,
and foreground/background separation, where classical PCA (L2) is
destroyed by a single bad entry.

Accelerator shape: every inexact-ALM iteration is one singular-value
soft-threshold (an SVD — the matmul-heavy step) plus elementwise
shrinkage and residual updates, all fused in ONE jitted step function
with (mu, rho, lambda) as traced scalars so the whole sweep compiles
once. The loop runs eagerly in Python on the device arrays (the
stopping rule needs the residual scalar anyway) with a fixed max_iter
bound.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.mat_utils import PRECISION

__all__ = ["robust_pca"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


@jax.jit
def _ialm_step(m, s, y, mu, lam):
    """One inexact-ALM sweep; returns (l, s, y, residual_fro)."""
    # singular-value soft-threshold of (M - S + Y/mu) at 1/mu
    u, sig, vt = jnp.linalg.svd(m - s + y / mu, full_matrices=False)
    sig_t = jnp.maximum(sig - 1.0 / mu, 0.0)
    l_new = _mm(u * sig_t[None, :], vt)
    # elementwise shrinkage of (M - L + Y/mu) at lam/mu
    g = m - l_new + y / mu
    s_new = jnp.sign(g) * jnp.maximum(jnp.abs(g) - lam / mu, 0.0)
    resid = m - l_new - s_new
    y_new = y + mu * resid
    return l_new, s_new, y_new, jnp.linalg.norm(resid)


@jax.jit
def _ialm_step_gram(m, s, y, mu, lam):
    """Sharding-friendly IALM sweep: the singular-value soft-threshold
    goes through eigh of the (n, n) Gram A^T A instead of a dense SVD.

    With rows of A sharded over a mesh, the Gram contraction psums one
    (n, n) block per device under GSPMD and the eigh replicates; a dense
    jnp.linalg.svd would force XLA to all-gather the full tall matrix
    onto every device. L = A V diag(s_t/s) V^T never forms U. Requires
    modest n (the short axis); sqrt of eigenvalues halves the digits of
    the SMALL singular values only — exactly the ones the threshold
    zeroes, so L matches the SVD path at f64 tolerances.
    """
    a = m - s + y / mu
    g = _mm(a.T, a)                                # psum over row shards
    evals, v = jnp.linalg.eigh(g)                  # ascending, replicated
    sig = jnp.sqrt(jnp.maximum(evals, 0.0))
    sig_t = jnp.maximum(sig - 1.0 / mu, 0.0)
    tiny = jnp.finfo(a.dtype).tiny
    scale = jnp.where(sig_t > 0.0, sig_t / jnp.maximum(sig, tiny), 0.0)
    l_new = _mm(_mm(a, v) * scale[None, :], v.T)   # rows stay sharded
    gsh = m - l_new + y / mu
    s_new = jnp.sign(gsh) * jnp.maximum(jnp.abs(gsh) - lam / mu, 0.0)
    resid = m - l_new - s_new
    y_new = y + mu * resid
    return l_new, s_new, y_new, jnp.linalg.norm(resid)


def robust_pca(m_data, lam: float | None = None, mu0: float | None = None,
               rho: float = 1.5, tol: float = 1e-7,
               max_iter: int = 200, mesh=None):
    """Decompose ``m_data`` into low-rank + sparse: M = L + S.

    lam: l1 weight (default the theoretically-universal
    1/sqrt(max(m, n))); mu0: initial penalty (default the standard
    1.25/||M||_2); rho: penalty growth per sweep; tol: relative
    Frobenius feasibility ||M-L-S||/||M||; max_iter: sweep bound.

    mesh: optional 1-D jax.sharding.Mesh — M/L/S/Y shard along the tall
    row axis and each sweep's SVD runs as a psum'd Gram + replicated
    (n, n) eigh (see _ialm_step_gram). Requires the
    column count to fit replicated on every device.

    Returns (l, s, info) with info = {iterations, rel_residual,
    rank (of L at the numerical-rank tolerance), nnz_frac (of S)}.
    """
    m = jnp.asarray(m_data)
    if m.ndim != 2:
        raise ValueError(f"m_data must be 2-d, got {m.ndim}-d")
    if max_iter < 1:
        raise ValueError(f"max_iter must be >= 1, got {max_iter}")
    if mesh is not None:
        from corrla_rs_tpu.parallel.mesh import shard_rows

        m = shard_rows(m, mesh)
    else:
        from corrla_rs_tpu.utils.smallpath import maybe_route_small

        (m,) = maybe_route_small(m)
    n_r, n_c = int(m.shape[0]), int(m.shape[1])
    if lam is None:
        lam = 1.0 / np.sqrt(max(n_r, n_c))
    if lam <= 0:
        raise ValueError(f"lam must be > 0, got {lam}")
    m_fro = float(jnp.linalg.norm(m))
    if m_fro == 0.0:
        z = jnp.zeros_like(m)
        return z, z, {"iterations": 0, "rel_residual": 0.0,
                      "rank": 0, "nnz_frac": 0.0}
    # one spectral norm serves both the penalty and the dual init
    m_2norm = float(jnp.linalg.norm(m, 2))
    if mu0 is None:
        mu0 = 1.25 / m_2norm        # standard IALM init (Lin et al.)
    # dual init Y = M / max(||M||_2, ||M||_inf / lam) (Lin et al.)
    scale = max(m_2norm, float(jnp.max(jnp.abs(m))) / lam)
    y = m / scale
    s = jnp.zeros_like(m)
    mu = jnp.asarray(float(mu0), m.dtype)
    lam_t = jnp.asarray(float(lam), m.dtype)
    step = _ialm_step if mesh is None else _ialm_step_gram
    it = 0
    rel = np.inf
    for it in range(1, int(max_iter) + 1):
        l_mat, s, y, r = step(m, s, y, mu, lam_t)
        rel = float(r) / m_fro
        if rel < float(tol):
            break
        mu = jnp.minimum(mu * rho, mu0 * 1e7)
    if mesh is None:
        sig = np.asarray(jnp.linalg.svd(l_mat, compute_uv=False))
        floor = max(n_r, n_c) * np.finfo(sig.dtype).eps * 10
    else:  # rank diagnostic without gathering the tall sharded L
        ev = np.asarray(jnp.linalg.eigh(_mm(l_mat.T, l_mat))[0])
        sig = np.sqrt(np.maximum(ev[::-1], 0.0))
        # Gram-derived small sigmas carry a sqrt(eps)-scale noise floor
        # (sqrt halves the digits); count rank above it, not above the
        # LAPACK-SVD floor
        floor = np.sqrt(np.finfo(sig.dtype).eps) * 10
    rank = int(np.sum(sig > sig[0] * floor)) if sig[0] > 0 else 0
    nnz = float(jnp.mean(jnp.abs(s) > 0))
    return l_mat, s, {"iterations": it, "rel_residual": rel,
                      "rank": rank, "nnz_frac": nnz}

"""Randomized Nystrom eigendecomposition of PSD matrices — EXTENSION.

The randomized family around random_svd.rs treats A as a general
matrix; symmetric positive-semidefinite matrices (kernel/covariance
Grams — exactly what the GP (ops/gp.py) and copula layers build) admit
a one-sketch factorization with twice the accuracy per matvec: the
Nystrom approximation

    A_hat = Y (Omega^T Y)^{-1} Y^T,   Y = A Omega

(Tropp, Yurtsever, Udell & Cevher 2017, fixed-rank PSD approximation
with shift stabilization). This module returns its eigendecomposition
directly — top-r eigenpairs of a PSD matrix from ONE pass over A.

Accelerator shape: everything is dense matmuls + one Cholesky of an (l, l)
core + one tall-skinny CholeskyQR2 + one (l, l) eigh — no host sync, no
general SVD. The stabilizing shift nu = eps * ||Y|| makes the core
Cholesky safe at f32 even when A's spectrum underflows the sketch.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.ops.random_svd import _cholesky_qr2
from corrla_rs_tpu.utils.prng import as_key

__all__ = ["nystrom_eigh", "nystrom_approx"]


@functools.partial(jax.jit, static_argnames=("rank", "n_oversamples"))
def _nystrom_kernel(a, rank: int, n_oversamples: int, key):
    n = a.shape[0]
    l = min(rank + n_oversamples, n)
    mm = functools.partial(jnp.matmul, precision=PRECISION)
    omega = jax.random.normal(key, (n, l), dtype=a.dtype)
    y = mm(a, omega)
    # shift: nu ~ eps * ||Y||_F guards the core Cholesky against
    # numerically-indefinite sketches (Tropp et al. 2017, eq. 2.8)
    nu = jnp.finfo(a.dtype).eps * jnp.linalg.norm(y)
    y_nu = y + nu * omega
    b = mm(omega.T, y_nu)
    c = jnp.linalg.cholesky(0.5 * (b + b.T))
    # F = Y_nu C^{-T}: A_hat = F F^T - nu I on the sketch range
    f = jax.scipy.linalg.solve_triangular(
        c, y_nu.T, lower=True
    ).T                                           # (n, l)
    # eigendecomposition of F F^T via thin QR + small eigh (no SVD):
    # F = Q R ; F F^T = Q (R R^T) Q^T ; eigh the (l, l) core
    q = _cholesky_qr2(f)
    r = mm(q.T, f)                                # (l, l)
    evals, w = jnp.linalg.eigh(mm(r, r.T))
    evals = jnp.maximum(evals - nu, 0.0)          # undo the shift
    # eigh returns ascending; take the top `rank` in descending order
    idx = jnp.arange(l - 1, l - 1 - rank, -1)
    return jnp.take(evals, idx), mm(q, jnp.take(w, idx, axis=1))


def nystrom_eigh(a, rank: int, n_oversamples: int = 8, key=0):
    """Top-``rank`` eigenpairs of a PSD matrix from one sketch pass.

    Returns ``(eigvals (rank,) descending, eigvecs (n, rank))`` of the
    Nystrom approximation ``A_hat = Y (Omega^T Y)^{-1} Y^T``. For
    spectra that decay past ``rank`` the pairs match the true top
    eigenpairs with error O(eigval_{rank+1}); the approximation error
    ``||A - A_hat||`` is within a modest factor of the best rank-``l``
    error (Tropp et al. 2017, thm 4.1).

    ``a`` must be symmetric PSD (n, n) — this is NOT checked (one extra
    pass would double the cost); a symmetric indefinite input produces
    garbage silently. Use ``ops.random_svd`` for general matrices.
    """
    a = jnp.asarray(a)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"a must be square (n, n), got {a.shape}")
    if not 1 <= rank <= a.shape[0]:
        raise ValueError(
            f"rank must be in [1, {a.shape[0]}], got {rank}"
        )
    return _nystrom_kernel(a, int(rank), int(n_oversamples), as_key(key))


def nystrom_approx(a, rank: int, n_oversamples: int = 8, key=0):
    """Rank-``rank`` PSD approximation factor: returns ``f (n, rank)``
    with ``A ~= f @ f.T`` (an exact PSD factorization of the truncated
    Nystrom approximant — e.g. a kernel-matrix preconditioner or a
    feature map for downstream least squares)."""
    evals, vecs = nystrom_eigh(a, rank, n_oversamples=n_oversamples,
                               key=key)
    return vecs * jnp.sqrt(evals)[None, :]

"""Kernel DMD (kernel EDMD) — EXTENSION.

models/edmd.py lifts through an EXPLICIT dictionary, whose size explodes
combinatorially with the state dimension (a degree-4 polynomial basis in
n=100 variables has ~4.6M terms). Kernel EDMD (Williams, Rowley &
Kevrekidis 2015, "A kernel-based method for data-driven Koopman spectral
analysis") runs the same regression implicitly in a reproducing-kernel
Hilbert space using only the m x m snapshot Grams:

    G_ij = k(x_i, x_j),   A_ij = k(y_i, x_j)
    G = Q S^2 Q^T (rank-r truncated)
    K_hat = (S^+ Q^T) A (Q S^+)            (r, r)

so the cost is set by the NUMBER OF SNAPSHOTS m, never by the dictionary
size (a polynomial kernel of degree p implicitly carries the full
degree-p monomial basis). Eigenpairs of K_hat give Koopman eigenvalues;
eigenfunction values at the training points are Phi = Q S V, at new
points phi(x) = k(x, X) Q S^+ V; Koopman modes solve X^T = Phi Xi^T.

``gram_method='nystrom'`` replaces the exact m x m eigh with the
one-pass randomized Nystrom eigendecomposition (ops/nystrom.py) — the
"randomized kernelized DMD" route (PAPERS.md: arxiv 2601.22867) for
large snapshot counts.

Accelerator shape: both Grams are one dense matmul each (pairwise distances
via the expanded-square form — no (m, m, n) intermediates); the
truncation is an on-device eigh (or Nystrom sketch); only the tiny
(r, r) complex spectral algebra goes to host numpy, same split as
models/dmd.py.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.eig import eig_host
from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.utils.checkpoint import register_model_class

__all__ = ["KernelDmd"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


def _kernel_cross(x, z, kernel: str, length_scale, degree, coef0):
    """k(x_cols, z_cols): (cx, cz) kernel matrix for column data."""
    if kernel == "rbf":
        d2 = (
            jnp.sum(x * x, axis=0)[:, None]
            - 2.0 * _mm(x.T, z)
            + jnp.sum(z * z, axis=0)[None, :]
        )
        return jnp.exp(-jnp.maximum(d2, 0.0) / (2.0 * length_scale ** 2))
    if kernel == "poly":
        return (_mm(x.T, z) / length_scale ** 2 + coef0) ** degree
    # linear
    return _mm(x.T, z) / length_scale ** 2


@functools.partial(jax.jit, static_argnames=("kernel", "degree", "rank"))
def _kdmd_kernel(x, y, kernel, length_scale, degree, coef0, rank):
    g = _kernel_cross(x, x, kernel, length_scale, degree, coef0)
    a = _kernel_cross(y, x, kernel, length_scale, degree, coef0)
    evals, q = jnp.linalg.eigh(0.5 * (g + g.T))
    m = g.shape[0]
    idx = jnp.arange(m - 1, m - 1 - rank, -1)
    evals = jnp.take(evals, idx)
    q = jnp.take(q, idx, axis=1)
    return g, a, evals, q


@register_model_class
class KernelDmd:
    """Koopman spectral analysis from kernel Grams (kernel EDMD).

    Parameters
    ----------
    x_data : (n, m) snapshot columns; consecutive columns pair unless
        ``y_data`` gives successors explicitly.
    rank : truncation rank r of the kernel Gram (number of Koopman
        eigenpairs retained). Required — the Gram's numerical rank is
        what regularizes the problem.
    kernel : 'rbf' (default), 'poly', or 'linear'.
    length_scale : RBF length scale / poly+linear inner-product scale.
    degree, coef0 : polynomial kernel (x.z/ls^2 + coef0)^degree — its
        RKHS is exactly the total-degree-``degree`` monomial basis, so
        polynomial Koopman-invariant subspaces are captured EXACTLY
        without ever forming the basis.
    gram_method : 'eigh' (exact, default) or 'nystrom' (one-pass
        randomized, for large m; key= seeds the sketch).
    eps : relative eigenvalue floor — Gram directions below
        eps * max_eval are discarded (rank shrinks to the numerical
        rank; keeps S^+ bounded).

    Attributes after fit: ``lambdas`` (complex (r,), magnitude-sorted),
    ``modes`` (complex (n, r) Koopman modes), ``eigenfunctions(x)``,
    ``predict(x0, n_steps)`` spectral forecast.
    """

    def __init__(self, x_data, rank: int, kernel: str = "rbf",
                 length_scale: float = 1.0, degree: int = 2,
                 coef0: float = 1.0, gram_method: str = "eigh",
                 eps: float = 1.0e-10, key=0, y_data=None):
        if kernel not in ("rbf", "poly", "linear"):
            raise ValueError(
                f"kernel must be 'rbf', 'poly' or 'linear', got {kernel!r}"
            )
        if gram_method not in ("eigh", "nystrom"):
            raise ValueError(
                f"gram_method must be 'eigh' or 'nystrom', "
                f"got {gram_method!r}"
            )
        from corrla_rs_tpu.utils.smallpath import maybe_route_small

        (x_data,) = maybe_route_small(x_data)
        x = jnp.asarray(x_data)
        if x.ndim != 2 or x.shape[1] < 2:
            raise ValueError(
                f"x_data must be (n, m >= 2), got {np.shape(x_data)}"
            )
        if y_data is None:
            y = x[:, 1:]
            x = x[:, :-1]
        else:
            y = jnp.asarray(y_data, dtype=x.dtype)
            if y.shape != x.shape:
                raise ValueError(
                    f"y_data shape {y.shape} != x_data shape {x.shape}"
                )
        m = int(x.shape[1])
        if not 1 <= rank <= m:
            raise ValueError(f"rank must be in [1, {m}], got {rank}")
        self.n_state = int(x.shape[0])
        self.kernel = kernel
        self.length_scale = float(length_scale)
        self.degree = int(degree)
        self.coef0 = float(coef0)
        self.rank = int(rank)
        self._x_train = x

        ls = jnp.asarray(self.length_scale, x.dtype)
        c0 = jnp.asarray(self.coef0, x.dtype)
        if gram_method == "nystrom":
            from corrla_rs_tpu.ops.nystrom import nystrom_eigh

            g = _kernel_cross(x, x, kernel, ls, self.degree, c0)
            a = _kernel_cross(y, x, kernel, ls, self.degree, c0)
            evals, q = nystrom_eigh(g, self.rank, key=key)
        else:
            g, a, evals, q = _kdmd_kernel(
                x, y, kernel, ls, self.degree, c0, self.rank
            )
        # numerical-rank floor: directions below eps*max are noise and
        # S^+ would blow up on them
        evals = np.asarray(evals, np.float64)
        q = np.asarray(q, np.float64)
        keep = evals > float(eps) * max(evals.max(), 0.0) + 1e-300
        evals, q = evals[keep], q[:, keep]
        self.rank = int(evals.size)
        s = np.sqrt(evals)
        s_inv = 1.0 / s
        proj = q * s_inv[None, :]                         # Q S^+
        k_hat = (proj.T @ np.asarray(a, np.float64)) @ proj
        lam, v = eig_host(k_hat)
        order = np.argsort(-np.abs(lam))
        lam, v = lam[order], v[:, order]
        self.lambdas = lam
        self._qsv = proj @ v                              # k(.,X)->phi map
        phi_train = (q * s[None, :]) @ v                  # (m, r) Phi
        # modes: X^T = Phi Xi^T (least squares; Phi may be rank-deficient)
        xi_t, _, _, _ = np.linalg.lstsq(
            phi_train, np.asarray(x.T, np.float64), rcond=None
        )
        self.modes = xi_t.T                               # (n, r) complex

    def eigenfunctions(self, x_new) -> np.ndarray:
        """phi(x) (r, c) complex host array at state columns ``x_new``
        (same magnitude-sorted order as ``lambdas``)."""
        xq = jnp.asarray(x_new, dtype=self._x_train.dtype)
        one_d = xq.ndim == 1
        if one_d:
            xq = xq[:, None]
        if xq.shape[0] != self.n_state:
            raise ValueError(
                f"x must have {self.n_state} rows, got {xq.shape[0]}"
            )
        kq = _kernel_cross(
            xq, self._x_train, self.kernel,
            jnp.asarray(self.length_scale, xq.dtype), self.degree,
            jnp.asarray(self.coef0, xq.dtype),
        )                                                  # (c, m)
        return (np.asarray(kq, np.float64) @ self._qsv).T  # (r, c)

    def predict(self, x_0, n_steps: int) -> np.ndarray:
        """Spectral forecast (n, n_steps): x_t = Xi (Lambda^t phi(x_0));
        complex algebra on host (r is small), real part returned."""
        phi0 = self.eigenfunctions(np.asarray(x_0).reshape(-1))[:, 0]
        t = np.arange(1, int(n_steps) + 1)
        lam_t = self.lambdas[None, :] ** t[:, None]        # (T, r)
        xs = (lam_t * phi0[None, :]) @ self.modes.T        # (T, n)
        return np.real(xs.T)

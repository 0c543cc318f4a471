"""Sparsity-promoting DMD amplitude selection — EXTENSION (no
reference analogue; Jovanovic, Schmid & Nichols, Phys. Fluids 2014).

A rank-r DMD leaves the question "which of the r modes matter?"
unanswered: least-squares amplitudes are generically all nonzero, and
picking by |b_j| ignores mode interactions. spDMD answers it by
solving, over the REAL objective

    J(b) = || X - Phi diag(b) V ||_F^2
         = b^H P b - q^H b - b^H q + s,
    P = (Phi^H Phi) o conj(V V^H),  q = conj(diag(V X^H Phi)),

the l1-regularized problem min_b J(b) + gamma ||b||_1 (ADMM), then a
POLISHING step: re-solve the unregularized LS restricted to the
selected support. Sweeping gamma traces the Pareto front between
model order (nnz) and performance loss.

Accelerator shape: the only data-sized contractions are Phi^H Phi and
X^H Phi — computed as real matmuls on device (complex split into
re/im parts). Everything after is
O(r^2) host complex: the r x r ADMM iteration and the polishing solve.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.mat_utils import PRECISION

__all__ = ["spdmd"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


def _complex_grams(phi_re, phi_im, x):
    """(Phi^H Phi, X^H Phi) with the data-sized contractions on
    device as real matmuls; returns host complex arrays."""
    pp_re = np.asarray(_mm(phi_re.T, phi_re) + _mm(phi_im.T, phi_im),
                       np.float64)
    pp_im = np.asarray(_mm(phi_re.T, phi_im) - _mm(phi_im.T, phi_re),
                       np.float64)
    xp_re = np.asarray(_mm(x.T, phi_re), np.float64)
    xp_im = np.asarray(_mm(x.T, phi_im), np.float64)
    return pp_re + 1j * pp_im, xp_re + 1j * xp_im


def _soft(v, k):
    """Complex soft-thresholding (the l1 prox)."""
    mag = np.abs(v)
    scale = np.maximum(1.0 - k / np.maximum(mag, 1e-300), 0.0)
    return scale * v


def spdmd(fit, x_data, gammas, rho: float = 1.0, maxiter: int = 2000,
          eps_abs: float = 1e-7, eps_rel: float = 1e-5):
    """Sparsity-promoting amplitude selection for a fitted DMD model.

    fit: a fitted :class:`~corrla_rs_tpu.models.dmd.DMD` (or any object
    with ``modes_re``/``modes_im`` (n, r), complex ``lambdas`` (r,));
    x_data: the (n, m) snapshots the fit should reconstruct;
    gammas: scalar or sequence of l1 weights (sweep it for the Pareto
    front); rho/maxiter/eps: ADMM knobs.

    Returns a dict of arrays aligned with ``gammas``:
    ``amplitudes`` (G, r) complex POLISHED amplitudes (exact LS on each
    selected support), ``nnz`` (G,), ``ploss_pct`` (G,) performance
    loss 100 * ||X - rec|| / ||X||, plus ``gammas``.
    """
    lam = np.asarray(fit.lambdas)
    r = lam.shape[0]
    x = jnp.asarray(x_data)
    if x.ndim != 2 or x.shape[0] != fit.modes_re.shape[0]:
        raise ValueError(
            f"x_data must be ({fit.modes_re.shape[0]}, m), got "
            f"{np.shape(x_data)}"
        )
    m = int(x.shape[1])
    gammas_arr = np.atleast_1d(np.asarray(gammas, np.float64))
    if np.any(gammas_arr < 0):
        raise ValueError("gammas must be >= 0")

    # Vandermonde over the snapshot times
    vand = lam[:, None] ** np.arange(m)[None, :]          # (r, m)
    pp, xp = _complex_grams(fit.modes_re, fit.modes_im, x)
    p_mat = pp * np.conj(vand @ vand.conj().T)            # (r, r)
    q = np.conj(np.diag(vand @ xp))                       # (r,)
    s = float(np.asarray(jnp.sum(x * x)))
    # guard: P is Hermitian PSD; tiny ridge for rank-deficient fits
    p_mat = p_mat + 1e-12 * np.trace(p_mat).real / r * np.eye(r)

    def j_of(b):
        return float(np.real(b.conj() @ p_mat @ b
                             - q.conj() @ b - b.conj() @ q + s))

    # cholesky of (P + rho/2 I) reused across ADMM iterations
    amps = np.zeros((gammas_arr.size, r), np.complex128)
    nnz = np.zeros(gammas_arr.size, int)
    ploss = np.zeros(gammas_arr.size)
    j0 = max(j_of(np.linalg.solve(p_mat, q)), 0.0)
    denom = max(s, 1e-300)
    from scipy.linalg import cho_factor, cho_solve

    # gamma-invariant: factor (P + rho/2 I) once for the whole sweep
    cf = cho_factor(p_mat + 0.5 * rho * np.eye(r))
    for gi, gamma in enumerate(gammas_arr):
        b = np.linalg.solve(p_mat, q)
        z = b.copy()
        u = np.zeros(r, np.complex128)
        for _ in range(int(maxiter)):
            b = cho_solve(cf, q + 0.5 * rho * (z - u))
            z_old = z
            z = _soft(b + u, gamma / rho) if gamma > 0 else b + u
            u = u + b - z
            pri = np.linalg.norm(b - z)
            dua = rho * np.linalg.norm(z - z_old)
            tol_p = (np.sqrt(r) * eps_abs
                     + eps_rel * max(np.linalg.norm(b),
                                     np.linalg.norm(z)))
            tol_d = np.sqrt(r) * eps_abs + eps_rel * rho * np.linalg.norm(u)
            if pri < tol_p and dua < tol_d:
                break
        keep = np.abs(z) > 1e-12
        nnz[gi] = int(np.sum(keep))
        b_pol = np.zeros(r, np.complex128)
        if nnz[gi]:
            # polishing: exact LS on the selected support
            pk = p_mat[np.ix_(keep, keep)]
            b_pol[keep] = np.linalg.solve(pk, q[keep])
        amps[gi] = b_pol
        ploss[gi] = 100.0 * np.sqrt(
            max(j_of(b_pol), 0.0) / denom
        )
    return {"gammas": gammas_arr, "amplitudes": amps, "nnz": nnz,
            "ploss_pct": ploss, "ploss_floor_pct":
                100.0 * np.sqrt(j0 / denom)}

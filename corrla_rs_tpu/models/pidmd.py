"""Physics-informed DMD (piDMD) — EXTENSION (no reference analogue).

The reference's DMD family (dmd_rom.rs) fits an UNCONSTRAINED operator,
so noise freely violates whatever physics the data obeys: energy leaks
from conservative systems, self-adjoint operators come back asymmetric,
shift-invariant dynamics come back space-varying. piDMD (Baddoo,
Herrmann, McKeon & Brunton 2023) solves the same regression RESTRICTED
to a matrix manifold; every family below has a closed-form solution, so
the physics is exact by construction and the noise can only move the
fit within the manifold.

Families and their closed forms (X1, X2 the snapshot pair matrices):
- 'orthogonal'     A = U_p V_p^T from the polar SVD of X2 X1^T
                   (orthogonal Procrustes) — energy-conserving systems;
                   the spectrum lands ON the unit circle by construction.
- 'symmetric' /    in the left-singular basis of X1 = U S V^T with
  'skewsymmetric'  Y = U^T X2 V: A~_ij = (s_j Y_ij +/- s_i Y_ji) /
                   (s_j^2 + s_i^2) — self-adjoint (real spectrum) /
                   skew-adjoint (imaginary spectrum) systems.
- 'diagonal'       a_i = <x2_i, x1_i> / ||x1_i||^2 rowwise — uncoupled
                   local dynamics.
- 'circulant'      diagonalized by the DFT: eigenvalue per wavenumber
                   lam_k = <F_k X1, F_k X2> / ||F_k X1||^2 —
                   spatially shift-invariant (periodic transport)
                   systems. Complex-free on device: the DFT rows are
                   two real matmuls (cos/sin), the rowwise complex
                   ratio is four real reductions.

Accelerator shape: 'orthogonal'/'symmetric'/'skewsymmetric' constrain the
rank-r POD-REDUCED operator (randomized SVD projection as dense matmuls, the
closed form on the r x r core, host eig of the tiny constrained core —
the same split as models/dmd.py); 'diagonal'/'circulant' act on the raw
state where the structure lives, as batched elementwise reductions /
DFT matmuls in one jit.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.ops.random_svd import random_svd
from corrla_rs_tpu.utils.checkpoint import register_model_class
from corrla_rs_tpu.utils.prng import as_key

__all__ = ["PiDmd"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)

_FAMILIES = ("orthogonal", "symmetric", "skewsymmetric", "diagonal",
             "circulant")


@functools.partial(jax.jit, static_argnames=("n_modes", "n_iters",
                                             "n_os", "family"))
def _reduced_kernel(x, n_modes, n_iters, n_os, family, key):
    """POD-projected constrained operator: returns (u (n_x, r),
    a_til (r, r) on-manifold)."""
    x1, x2 = x[:, :-1], x[:, 1:]
    u, s, vt = random_svd(x1, n_modes, n_iters, n_os, key=key)
    if family == "orthogonal":
        # Procrustes on the reduced pair: the projected regression
        # min ||U^T X2 - A~ U^T X1|| over orthogonal A~ has solution
        # from the polar part of (U^T X2)(U^T X1)^T
        m = _mm(_mm(u.T, x2), _mm(u.T, x1).T)
        uu, _, vv = jnp.linalg.svd(m, full_matrices=False)
        a_til = _mm(uu, vv)
    else:
        # X1 = U S V^T exactly on the retained subspace; Y = U^T X2 V
        y = _mm(_mm(u.T, x2), vt.T)
        s2 = s[None, :] ** 2 + s[:, None] ** 2
        s2 = jnp.maximum(s2, jnp.finfo(s.dtype).tiny)
        if family == "symmetric":
            a_til = (s[None, :] * y + s[:, None] * y.T) / s2
        else:  # skewsymmetric
            a_til = (s[None, :] * y - s[:, None] * y.T) / s2
    return u, a_til


@jax.jit
def _diagonal_kernel(x):
    x1, x2 = x[:, :-1], x[:, 1:]
    num = jnp.sum(x2 * x1, axis=1)
    den = jnp.maximum(jnp.sum(x1 * x1, axis=1),
                      jnp.finfo(x.dtype).tiny)
    return num / den


@jax.jit
def _circulant_kernel(x):
    """Per-wavenumber complex gain (lam_re, lam_im) of the circulant
    LS fit, plus the DFT'd snapshots are never materialized beyond two
    (n_x, n_t) real matmul results per part."""
    n_x = x.shape[0]
    k = jnp.arange(n_x, dtype=x.dtype)[:, None]
    j = jnp.arange(n_x, dtype=x.dtype)[None, :]
    ang = 2.0 * jnp.pi * k * j / n_x
    c, s = jnp.cos(ang), -jnp.sin(ang)          # F = C + iS rows
    x1, x2 = x[:, :-1], x[:, 1:]
    a_re, a_im = _mm(c, x1), _mm(s, x1)          # F X1
    b_re, b_im = _mm(c, x2), _mm(s, x2)          # F X2
    # lam_k = <F_k X1, F_k X2> / ||F_k X1||^2  (conj on X1)
    den = jnp.maximum(jnp.sum(a_re**2 + a_im**2, axis=1),
                      jnp.finfo(x.dtype).tiny)
    num_re = jnp.sum(a_re * b_re + a_im * b_im, axis=1)
    num_im = jnp.sum(a_re * b_im - a_im * b_re, axis=1)
    return num_re / den, num_im / den


@register_model_class
class PiDmd:
    """Physics-informed DMD: ``PiDmd(x, n_modes, family=...)``.

    x: (n_x, n_t) snapshot columns; family: one of 'orthogonal',
    'symmetric', 'skewsymmetric' (constraining the rank-``n_modes``
    POD-reduced operator), 'diagonal' or 'circulant' (constraining the
    raw-state operator; ``n_modes`` is ignored — the structure fixes
    the parameter count).

    After fit: ``lambdas`` (complex host array) — ON the manifold's
    spectrum locus by construction (unit circle / real axis / imaginary
    axis / per-row gains / per-wavenumber gains); ``predict_multiple``
    rolls the constrained operator. For the reduced families,
    ``modes_re``/``modes_im`` (n_x, r) hold the lifted eigenvectors and
    ``a_til`` the reduced operator.
    """

    def __init__(self, x_data, n_modes: int = 0,
                 family: str = "orthogonal", n_iters: int = 10, key=0,
                 n_oversamples: int = 8):
        from corrla_rs_tpu.ops.eig import eig_host
        from corrla_rs_tpu.utils.smallpath import maybe_route_small

        if family not in _FAMILIES:
            raise ValueError(
                f"family must be one of {_FAMILIES}, got {family!r}"
            )
        x = jnp.asarray(x_data)
        if x.ndim != 2 or x.shape[1] < 3:
            raise ValueError(
                f"x_data must be (n_x, n_t >= 3), got {np.shape(x_data)}"
            )
        (x,) = maybe_route_small(x)
        self.family = family
        self.n_state = int(x.shape[0])
        if family in ("orthogonal", "symmetric", "skewsymmetric"):
            r = int(n_modes)
            if not 1 <= r <= min(self.n_state, int(x.shape[1]) - 1):
                raise ValueError(
                    f"n_modes must be in [1, min(n_x, n_t-1)], got "
                    f"{n_modes}"
                )
            self.n_modes = r
            u, a_til = _reduced_kernel(
                x, r, int(n_iters), int(n_oversamples), family,
                as_key(key)
            )
            self.u = u
            self.a_til = a_til
            lam, w = eig_host(np.asarray(a_til, np.float64))
            self.lambdas = lam
            phi = np.asarray(u, np.float64) @ w
            self.modes_re = jnp.asarray(np.ascontiguousarray(phi.real),
                                        x.dtype)
            self.modes_im = jnp.asarray(np.ascontiguousarray(phi.imag),
                                        x.dtype)
        elif family == "diagonal":
            self.n_modes = self.n_state
            self.gains = _diagonal_kernel(x)
            self.lambdas = np.asarray(self.gains,
                                      np.float64).astype(np.complex128)
        else:  # circulant
            self.n_modes = self.n_state
            lam_re, lam_im = _circulant_kernel(x)
            self.lam_re, self.lam_im = lam_re, lam_im
            self.lambdas = (np.asarray(lam_re, np.float64)
                            + 1j * np.asarray(lam_im, np.float64))

    def predict_multiple(self, x_0, n_steps: int) -> jnp.ndarray:
        """(n_x, n_steps) rollout of the constrained operator from
        x_0 (n_x,) or (n_x, 1)."""
        x0 = jnp.asarray(x_0).reshape(-1)
        if x0.shape[0] != self.n_state:
            raise ValueError(
                f"x_0 must have {self.n_state} entries, got {x0.shape}"
            )
        n = int(n_steps)
        if self.family in ("orthogonal", "symmetric", "skewsymmetric"):
            z0 = _mm(self.u.T, x0[:, None])[:, 0]

            def step(z, _):
                z = _mm(self.a_til, z[:, None])[:, 0]
                return z, z

            _, zs = jax.lax.scan(step, z0, None, length=n)
            return _mm(self.u, zs.T)
        if self.family == "diagonal":
            p = self.gains[:, None] ** jnp.arange(1, n + 1)[None, :]
            return x0[:, None] * p
        # circulant: powers of the per-wavenumber gains in DFT space
        n_x = self.n_state
        k = jnp.arange(n_x, dtype=self.lam_re.dtype)[:, None]
        j = jnp.arange(n_x, dtype=self.lam_re.dtype)[None, :]
        ang = 2.0 * jnp.pi * k * j / n_x
        c, s = jnp.cos(ang), -jnp.sin(ang)
        z_re = _mm(c, x0[:, None])[:, 0]
        z_im = _mm(s, x0[:, None])[:, 0]
        lam = (np.asarray(self.lam_re, np.float64)
               + 1j * np.asarray(self.lam_im, np.float64))
        pows = lam[:, None] ** np.arange(1, n + 1)[None, :]   # (n_x, n)
        z = (np.asarray(z_re, np.float64)
             + 1j * np.asarray(z_im, np.float64))[:, None] * pows
        # inverse DFT row k -> sum_j exp(+2pi i k j / n) / n
        zr = jnp.asarray(np.ascontiguousarray(z.real), self.lam_re.dtype)
        zi = jnp.asarray(np.ascontiguousarray(z.imag), self.lam_re.dtype)
        return (_mm(c.T, zr) - _mm((-s).T, zi)) / n_x

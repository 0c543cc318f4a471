"""Matrix-utility layer.

Most of the reference's ``mat_utils.rs`` (965 LoC of faer helpers) evaporates
into ``jnp`` one-liners; this module keeps only the pieces whose *semantics*
must be preserved for parity with the reference:

- eps-regularized Moore-Penrose pseudoinverse (reference mat_utils.rs:37-53)
- diagonal pseudoinverse with zero-cutoff (reference mat_utils.rs:386-402)
- truncated SVD (reference mat_utils.rs:74-83)
- descending eigen-decomposition sort (reference mat_utils.rs:459-478)
- column centering / z-scoring (reference mat_utils.rs:482-519)
- the reference's quirky ``mat_linspace`` (reference mat_utils.rs:600-610)

Everything is a pure jnp function, jit-safe, dtype-polymorphic (f32/f64),
and states its matmul precision.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

# Matmul precision used in accuracy-sensitive cores (power iteration, Gram
# products). HIGHEST asks for full f32; the GPU's default for f32 is TF32
# (about 3 decimal digits), which misses sigma rel-err < 1e-6.
PRECISION = lax.Precision.HIGHEST


def pinv(a: jnp.ndarray, eps: float = 1.0e-14) -> jnp.ndarray:
    """Moore-Penrose pseudoinverse with eps-regularized singular values.

    Parity with reference mat_utils.rs:37-53: inverts every singular value
    as ``1 / (s + eps)`` (no rank cutoff). Identical to the reference on
    full-rank inputs; like the reference, it amplifies exact-zero singular
    values to ``1/eps`` — callers that need a rank-revealing pinv should use
    ``jnp.linalg.pinv`` instead.
    """
    u, s, vt = jnp.linalg.svd(a, full_matrices=False)
    s_inv = 1.0 / (s + jnp.asarray(eps, a.dtype))
    return jnp.matmul(vt.T * s_inv[None, :], u.T, precision=PRECISION)


def pinv_diag(d_mat: jnp.ndarray, eps: float = 1.0e-20) -> jnp.ndarray:
    """Pseudoinverse of a diagonal matrix with zero cutoff.

    Parity with reference mat_utils.rs:386-402: entries with |d| < eps map
    to 0, else to ``1 / (d + eps)``.
    """
    d = jnp.diagonal(d_mat)
    inv = jnp.where(jnp.abs(d) < eps, 0.0, 1.0 / (d + jnp.asarray(eps, d.dtype)))
    out = jnp.zeros_like(d_mat)
    n = min(d_mat.shape)
    return out.at[jnp.arange(n), jnp.arange(n)].set(inv.astype(d_mat.dtype))


def truncated_svd(a: jnp.ndarray, rank: int):
    """Exact truncated SVD: (U_r, s_r, Vt_r). Reference mat_utils.rs:74-83."""
    u, s, vt = jnp.linalg.svd(a, full_matrices=False)
    return u[:, :rank], s[:rank], vt[:rank, :]


def sort_evd(eigs: jnp.ndarray, eigvs: jnp.ndarray):
    """Sort eigenvalues (descending) and reorder eigenvectors to match.

    Parity with reference mat_utils.rs:459-478 (``sort_evd`` +
    ``argsort_float_rev``): sorts by *value* descending (the reference's
    docstring says magnitude but its comparator is plain value order).

    Args:
      eigs: (n,) eigenvalues or (n, n) diagonal matrix of eigenvalues.
      eigvs: (m, n) eigenvectors as columns.
    Returns:
      (sorted_eigs_diag (n, n), sorted_eigvs (m, n))
    """
    e = jnp.diagonal(eigs) if eigs.ndim == 2 else eigs
    order = jnp.argsort(-e)
    return jnp.diag(e[order]), eigvs[:, order]


def col_means(a: jnp.ndarray) -> jnp.ndarray:
    """Column means as a (1, n) row. Reference mat_utils.rs:87-119."""
    return jnp.mean(a, axis=0, keepdims=True)


def center_mat_col(a: jnp.ndarray) -> jnp.ndarray:
    """Subtract column means. Reference mat_utils.rs:482-499."""
    return a - col_means(a)


def zcenter_mat_col(a: jnp.ndarray, ddof: int = 1) -> jnp.ndarray:
    """Center columns to zero mean, unit std (sample std, ddof=1).

    Reference mat_utils.rs:503-519 (``zcenter_mat_col``; reference
    ``mat_std`` uses the n-1 denominator).
    """
    mu = col_means(a)
    sd = jnp.std(a, axis=0, keepdims=True, ddof=ddof)
    return (a - mu) / sd


def mat_linspace(start: float, end: float, n_steps: int, dtype=None) -> jnp.ndarray:
    """(n_steps, 1) column of ``i * (end - start) / n_steps``.

    Deliberate parity with the reference quirk (mat_utils.rs:600-610): the
    ``start`` argument is ignored for the offset (values begin at 0) and the
    endpoint is excluded. Used by reference tests/fixtures only.
    """
    delta = (end - start) / n_steps
    return (jnp.arange(n_steps, dtype=dtype or jnp.result_type(float)) * delta)[:, None]


def mat_pinv_comp(x, eps: float = 1.0e-16, mode: str = "reference"):
    """Complex Moore-Penrose pseudoinverse (host numpy).

    Runs on host LAPACK: every caller (DMDc mode algebra) needs it only
    for tiny (n, r) matrices.

    mode="reference": parity with reference mat_utils.rs:56-71 — inverts
      every singular value as ``1 / (s + eps)`` with additive eps and no
      rank cutoff. Exact reference semantics, including its blow-up on
      rank-deficient inputs (junk directions amplified by ~1/eps).
    mode="cutoff": rank-revealing variant — singular values below
      ``eps * s_max`` are zeroed (here eps is a RELATIVE tolerance, e.g.
      1e-10). This is what DMDc uses; see models/dmd.py for the measured
      failure of the reference formula on over-parameterized fits.
    """
    import numpy as np

    x = np.asarray(x)
    u, s, vh = np.linalg.svd(x, full_matrices=False)
    if mode == "reference":
        s_inv = 1.0 / (s + eps)
    elif mode == "cutoff":
        cutoff = eps * (s[0] if s.size else 1.0)
        s_inv = np.where(s > cutoff, 1.0 / np.maximum(s, 1e-300), 0.0)
    else:
        raise ValueError(f"unknown mode {mode!r} (use 'reference'|'cutoff')")
    return (vh.conj().T * s_inv[None, :]) @ u.conj().T


def pinv_comp_parts(x_re: jnp.ndarray, x_im: jnp.ndarray, rtol: float | None = None):
    """Complex Moore-Penrose pseudoinverse ON DEVICE, complex-free.

    Same rank-cutoff semantics as ``mat_pinv_comp(mode="cutoff")`` but
    jit/vmap-safe on backends with no complex dtype: the complex matrix X = Xr + i Xi is embedded as the real
    2n x 2r matrix [[Xr, -Xi], [Xi, Xr]]; the embedding is a *-algebra
    homomorphism, so pinv(emb(X)) = emb(pinv(X)) and the pinv's real/imag
    parts are read back off the blocks. Singular values of the embedding
    are those of X, doubled, so the relative cutoff carries over exactly.

    rtol defaults dtype-aware: 1e-10 for f64 (matching mat_pinv_comp's
    DMDc usage), 1e-5 for f32 (junk directions sit at ~n*eps*s_max there).
    Returns ``(p_re, p_im)`` of shape (r, n) for (n, r) input parts.
    """
    if rtol is None:
        rtol = 1.0e-10 if x_re.dtype == jnp.float64 else 1.0e-5
    n, r = x_re.shape
    top = jnp.concatenate([x_re, -x_im], axis=1)
    bot = jnp.concatenate([x_im, x_re], axis=1)
    emb = jnp.concatenate([top, bot], axis=0)
    u, s, vt = jnp.linalg.svd(emb, full_matrices=False)
    cutoff = rtol * s[0]
    s_inv = jnp.where(s > cutoff, 1.0 / jnp.maximum(s, 1e-300), 0.0)
    p = jnp.matmul(vt.T * s_inv[None, :], u.T, precision=PRECISION)
    return p[:r, :n], p[r:, :n]


def complex_from_parts(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    """Join real/imag parts into a complex matrix. Reference mat_utils.rs:316-337."""
    return jnp.asarray(re) + 1j * jnp.asarray(im)


def parts_from_complex(c: jnp.ndarray):
    """Split a complex matrix into (re, im). Reference mat_utils.rs:316-337."""
    return jnp.real(c), jnp.imag(c)


def apply_operator(a, block):
    """A @ block for an explicit matrix or a batched-matvec callable
    (n, k) -> (n, k) — the library-wide matrix-free operator protocol
    (consumers: ops/trace_est, ops/slq, ops/cg)."""
    if callable(a):
        return jnp.asarray(a(block))
    return jnp.matmul(jnp.asarray(a), block, precision=PRECISION)


def fd_derivative(x, dt):
    """2nd-order finite-difference d/dt along axis 0: centered interior,
    one-sided 2nd-order ends. The shared stencil behind models/sindy and
    models/opinf derivative estimation."""
    interior = (x[2:] - x[:-2]) / (2.0 * dt)
    first = (-3.0 * x[0] + 4.0 * x[1] - x[2]) / (2.0 * dt)
    last = (3.0 * x[-1] - 4.0 * x[-2] + x[-3]) / (2.0 * dt)
    return jnp.concatenate([first[None], interior, last[None]], axis=0)

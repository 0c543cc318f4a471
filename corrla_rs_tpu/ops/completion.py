"""Low-rank matrix completion by alternating least squares — EXTENSION
(no reference analogue; the classic collaborative-filtering /
missing-data recovery problem, cf. Koren-Bell-Volinsky 2009 and the
nuclear-norm recovery theory of Candes-Recht 2009).

Given a partially observed matrix (mask of known entries), fit
M ~= U V^T of rank r by minimizing the squared error on the OBSERVED
entries plus ridge: the alternating updates are exact row-wise least
squares, each sweep a pair of closed-form batched solves.

Accelerator shape: the per-row normal equations for ALL rows are built
in one einsum each — G (n_rows, r, r) = sum_j mask_ij v_j v_j^T and
the right-hand sides in one masked matmul — then solved with one
batched jnp.linalg.solve. No gather/scatter over the observed set, no
sparse formats: the mask rides as a dense 0/1 matrix, which for dense matmuls
is faster than indexing until the matrix itself no longer fits.
Fixed-sweep lax.scan with an observed-entry RMSE history.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.ops.random_svd import random_svd
from corrla_rs_tpu.utils.prng import as_key

__all__ = ["matrix_complete"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


def _solve_side(m_obs, mask, v, lam):
    """Rowwise ridge LS: for every row i solve
    (sum_j mask_ij v_j v_j^T + lam I) u_i = sum_j mask_ij m_ij v_j."""
    r = v.shape[1]
    g = jnp.einsum("ij,jr,js->irs", mask, v, v,
                   precision=PRECISION)               # (n, r, r)
    g = g + lam * jnp.eye(r, dtype=v.dtype)[None]
    b = _mm(m_obs, v)                                  # mask pre-applied
    return jnp.linalg.solve(g, b[:, :, None])[:, :, 0]


@functools.partial(jax.jit, static_argnames=("n_sweeps",))
def _als_sweeps(m_obs, mask, u, v, lam, n_sweeps):
    n_obs = jnp.maximum(jnp.sum(mask), 1.0)

    def sweep(carry, _):
        u, v = carry
        u = _solve_side(m_obs, mask, v, lam)
        v = _solve_side(m_obs.T, mask.T, u, lam)
        resid = (m_obs - _mm(u, v.T) * mask)
        rmse = jnp.sqrt(jnp.sum(resid * resid) / n_obs)
        return (u, v), rmse

    (u, v), hist = jax.lax.scan(sweep, (u, v), None, length=n_sweeps)
    return u, v, hist


def matrix_complete(m_data, mask, rank: int, n_sweeps: int = 30,
                    lam: float = 1e-6, key=0, mesh=None):
    """Complete a partially observed matrix at the given rank.

    m_data: (m, n) with arbitrary values at UNOBSERVED positions (they
    are ignored); mask: (m, n) boolean/0-1 of observed entries;
    rank: model rank r; lam: ridge (relative to the observed scale —
    scaled internally by the observed mean square); n_sweeps: ALS
    sweeps (convergence is fast; inspect the returned history);
    mesh: optional 1-D jax.sharding.Mesh — rows of m/mask shard across
    devices (the U update is row-local; the V update's per-column
    Grams contract over the row axis, one psum under GSPMD).

    Returns (m_hat, u, v, rmse_hist): the completed matrix U V^T, its
    factors, and the per-sweep observed-entry RMSE.
    """
    m = jnp.asarray(m_data)
    if m.ndim != 2:
        raise ValueError(f"m_data must be 2-d, got {m.ndim}-d")
    if not jnp.issubdtype(m.dtype, jnp.floating):
        # integer ratings are the canonical input; an int carry dtype
        # would crash lax.scan and int-cast the ridge to zero
        m = m.astype(jnp.result_type(m.dtype, float))
    msk = jnp.asarray(mask)
    if msk.shape != m.shape:
        raise ValueError(
            f"mask shape {msk.shape} != data shape {m.shape}"
        )
    r = int(rank)
    if not 1 <= r <= min(m.shape):
        raise ValueError(f"rank must be in [1, min(m, n)], got {rank}")
    msk = msk.astype(m.dtype)
    frac = float(jnp.mean(msk))
    if frac == 0.0:
        raise ValueError("mask has no observed entries")
    # where(), not m * msk: NaN is the canonical missing-data marker
    # and NaN * 0 = NaN would poison everything downstream
    m_obs = jnp.where(msk != 0, m, 0.0)
    if mesh is not None:
        from corrla_rs_tpu.parallel.mesh import shard_rows

        m_obs = shard_rows(m_obs, mesh)
        msk = shard_rows(msk, mesh)
    # absolute ridge from the relative one: observed mean square sets
    # the scale so lam behaves the same across data magnitudes
    scale = float(jnp.sum(m_obs * m_obs)) / max(
        float(jnp.sum(msk)), 1.0
    )
    lam_abs = jnp.asarray(float(lam) * max(scale, 1e-300), m.dtype)
    # spectral init: right singular subspace of the zero-filled matrix
    # (subspaces are scale-invariant, so no 1/p rescale is needed)
    _, _, vt = random_svd(m_obs, r, 6, 8, key=as_key(key))
    v0 = vt.T
    u0 = jnp.zeros((int(m.shape[0]), r), m.dtype)
    u, v, hist = _als_sweeps(m_obs, msk, u0, v0, lam_abs,
                             int(n_sweeps))
    return _mm(u, v.T), u, v, hist

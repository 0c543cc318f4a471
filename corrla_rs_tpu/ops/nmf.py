"""Nonnegative matrix factorization (HALS) — EXTENSION (no reference
analogue; completes the constrained-factorization family next to
robust_pca and the CP/Tucker/TT tensor models).

X ~= W H with W, H >= 0: the parts-based decomposition (topics,
spectra, counts) that unconstrained SVD factors cannot give. Solver is
HALS (hierarchical alternating least squares, Cichocki-Phan 2009) —
per-component closed-form updates with far faster convergence than
multiplicative updates. Init is NNDSVD (Boutsidis-Gallopoulos 2008):
deterministic, from the randomized SVD's sign-split factors.

Accelerator shape: each sweep forms the two Gram pairs (X H^T, H H^T)
and (W^T X, W^T W) with dense dense matmuls; the per-component HALS
updates are an unrolled rank-length loop of rank-1 corrections inside
ONE jitted sweep, scanned for a fixed sweep count (static shapes, no
data-dependent control flow).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.ops.random_svd import random_svd

__all__ = ["nmf"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


def _hals_half(w, xh, hh, eps):
    """One HALS pass over W's columns given XH = X H^T, HH = H H^T."""
    r = w.shape[1]
    for j in range(r):
        grad_j = xh[:, j] - _mm(w, hh[:, j][:, None])[:, 0]
        w_j = w[:, j] + grad_j / jnp.maximum(hh[j, j], eps)
        w = w.at[:, j].set(jnp.maximum(w_j, 0.0))
    return w


@functools.partial(jax.jit, static_argnames=("n_sweeps",))
def _nmf_sweeps(x, w, h, n_sweeps):
    eps = jnp.finfo(x.dtype).eps
    x_norm = jnp.linalg.norm(x)

    def sweep(carry, _):
        w, h = carry
        w = _hals_half(w, _mm(x, h.T), _mm(h, h.T), eps)
        h = _hals_half(h.T, _mm(x.T, w), _mm(w.T, w), eps).T
        err = jnp.linalg.norm(x - _mm(w, h)) / jnp.maximum(x_norm, eps)
        return (w, h), err

    (w, h), errs = jax.lax.scan(sweep, (w, h), None, length=n_sweeps)
    return w, h, errs


def nmf(x_data, rank: int, n_sweeps: int = 200, key=0, mesh=None):
    """Nonnegative factorization X ~= W H (W (m, r), H (r, n) >= 0).

    Returns (w, h, rel_errs) with rel_errs the per-sweep relative
    Frobenius reconstruction error (non-increasing up to roundoff).

    mesh: optional 1-D jax.sharding.Mesh — X and W shard along the tall
    m axis, H replicates. The W-side HALS Grams (X H^T, H H^T) are
    device-local; the H-side Grams (W^T X, W^T W) contract the sharded
    axis, so GSPMD inserts one (r, n)+(r, r) psum per sweep — the same
    psum-Gram contract as parallel/sharded_hosvd.py.
    """
    x = jnp.asarray(x_data)
    if x.ndim != 2:
        raise ValueError(f"x_data must be 2-d, got {x.ndim}-d")
    if bool(jnp.any(x < 0)):
        raise ValueError("x_data must be nonnegative")
    r = int(rank)
    if not 1 <= r <= min(x.shape):
        raise ValueError(
            f"rank must be in [1, min(m, n)], got {rank}"
        )
    if mesh is not None:
        from corrla_rs_tpu.parallel.mesh import shard_rows

        x = shard_rows(x, mesh)
    # NNDSVD init: sign-split the leading singular factors (on a sharded
    # x the power-iteration Grams psum under GSPMD; the (m, r)/(r, n)
    # factors are assembled on host once — init-only cost)
    u, s, vt = random_svd(x, r, 6, min(8, int(min(x.shape))), key=key)
    u_np = np.asarray(u, np.float64)
    s_np = np.asarray(s, np.float64)
    v_np = np.asarray(vt, np.float64)
    w0 = np.empty((x.shape[0], r))
    h0 = np.empty((r, x.shape[1]))
    w0[:, 0] = np.sqrt(s_np[0]) * np.abs(u_np[:, 0])
    h0[0] = np.sqrt(s_np[0]) * np.abs(v_np[0])
    for j in range(1, r):
        up, un = np.maximum(u_np[:, j], 0), np.maximum(-u_np[:, j], 0)
        vp, vn = np.maximum(v_np[j], 0), np.maximum(-v_np[j], 0)
        norm_p = np.linalg.norm(up) * np.linalg.norm(vp)
        norm_n = np.linalg.norm(un) * np.linalg.norm(vn)
        if norm_p >= norm_n:
            scale = np.sqrt(s_np[j] * norm_p)
            w0[:, j] = scale * up / max(np.linalg.norm(up), 1e-300)
            h0[j] = scale * vp / max(np.linalg.norm(vp), 1e-300)
        else:
            scale = np.sqrt(s_np[j] * norm_n)
            w0[:, j] = scale * un / max(np.linalg.norm(un), 1e-300)
            h0[j] = scale * vn / max(np.linalg.norm(vn), 1e-300)
    # 'nndsvda' zero fill: exact zeros lock HALS columns (the update
    # max(0, .) can never reactivate a dead component); fill with the
    # data mean as sklearn does
    fill = float(np.asarray(jnp.mean(x)))
    w0[w0 == 0] = fill
    h0[h0 == 0] = fill
    w0_j = jnp.asarray(w0, x.dtype)
    h0_j = jnp.asarray(h0, x.dtype)
    if mesh is not None:
        from corrla_rs_tpu.parallel.mesh import shard_rows

        w0_j = shard_rows(w0_j, mesh)
    w, h, errs = _nmf_sweeps(x, w0_j, h0_j, int(n_sweeps))
    return w, h, errs

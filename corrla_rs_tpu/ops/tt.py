"""Tensor-train (TT) decomposition — EXTENSION.

The Tucker/HOSVD layer (ops/hosvd.py) compresses each mode against all
others but keeps a dense (r_1, ..., r_d) core — its memory is still
exponential in d. The tensor-train format (Oseledets 2011) replaces the
core with a chain of 3-way cores

    T[i_1, ..., i_d] = G_1[i_1] G_2[i_2] ... G_d[i_d],
    G_k[i_k] an (r_{k-1}, r_k) matrix,  r_0 = r_d = 1,

so storage is SUM_k r_{k-1} n_k r_k — linear in d. This is the right
format for high-dimensional parameter-study tensors (many small axes)
where Tucker's exponential core gives out; for d <= 4 snapshot tensors
Tucker usually compresses harder.

TT-SVD here is the sequential-unfolding algorithm built on the
library's randomized SVD core (parity random_svd.rs:63-110 semantics
for each unfolding): each step is one truncated SVD of a
(r_{k-1} n_k, prod tail) matrix — dense matmuls via ops/random_svd for
large unfoldings, exact jnp SVD for small ones. ``tt_round``
re-compresses an existing train (right-to-left QR orthogonalization
sweep, then left-to-right truncated-SVD sweep — the classic rounding
that restores quasi-optimality after TT arithmetic).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.ops.random_svd import random_svd
from corrla_rs_tpu.utils.prng import as_key

__all__ = ["tt_svd", "tt_reconstruct", "tt_round", "tt_dot", "tt_norm"]

_RSVD_MIN_ELEMS = 1 << 18   # below this an exact small SVD is cheaper
_mm = functools.partial(jnp.matmul, precision=PRECISION)


def _trunc_svd(c, rank, n_iters, key):
    """Rank-`rank` truncated SVD of c; randomized for large c."""
    m, n = c.shape
    rank = min(rank, m, n)
    if m * n >= _RSVD_MIN_ELEMS and rank + 8 < min(m, n):
        u, s, vt = random_svd(c, rank, n_iters, 8, key=key)
        return u, s, vt
    u, s, vt = jnp.linalg.svd(c, full_matrices=False)
    return u[:, :rank], s[:rank], vt[:rank, :]


def tt_svd(tensor, ranks, n_iters: int = 4, key=0):
    """TT decomposition with prescribed ranks.

    Parameters
    ----------
    tensor : d-way array (d >= 2).
    ranks : sequence of d-1 ints — TT ranks r_1..r_{d-1} (each is
        additionally capped at its unfolding's max possible rank).
    n_iters : power iterations for the randomized SVDs of large
        unfoldings.

    Returns a list of d cores, core k of shape (r_{k-1}, n_k, r_k)
    with r_0 = r_d = 1. Exact (to fp) when the tensor's TT ranks are
    <= ``ranks``; otherwise quasi-optimal: the error is within
    sqrt(d-1) of the best TT approximation at those ranks.
    """
    t = jnp.asarray(tensor)
    dims = t.shape
    d = t.ndim
    if d < 2:
        raise ValueError(f"tensor must have >= 2 axes, got shape {dims}")
    ranks = list(ranks)
    if len(ranks) != d - 1:
        raise ValueError(
            f"ranks must have {d - 1} entries for a {d}-way tensor, "
            f"got {len(ranks)}"
        )
    if any(r < 1 for r in ranks):
        raise ValueError(f"ranks must be >= 1, got {ranks}")
    key = as_key(key)
    cores = []
    r_prev = 1
    c = t.reshape(dims[0], -1)
    for k in range(d - 1):
        m = r_prev * dims[k]
        c = c.reshape(m, -1)
        r_k = min(ranks[k], m, c.shape[1])
        key, sub = jax.random.split(key)
        u, s, vt = _trunc_svd(c, r_k, n_iters, sub)
        cores.append(u.reshape(r_prev, dims[k], r_k))
        c = s[:, None] * vt
        r_prev = r_k
    cores.append(c.reshape(r_prev, dims[d - 1], 1))
    return cores


def tt_reconstruct(cores):
    """Contract a TT train back to the dense tensor."""
    t = jnp.asarray(cores[0])           # (1, n_1, r_1)
    for g in cores[1:]:
        g = jnp.asarray(g)
        left = t.reshape(-1, t.shape[-1])
        t = _mm(left, g.reshape(g.shape[0], -1))
        t = t.reshape(left.shape[0], g.shape[1], g.shape[2])
    return t.reshape(tuple(jnp.asarray(g).shape[1] for g in cores))


def tt_round(cores, ranks, n_iters: int = 4, key=0):
    """Re-compress a TT train to smaller ``ranks`` (d-1 ints).

    Right-to-left QR sweep makes every core right-orthogonal, so the
    subsequent left-to-right truncated-SVD sweep is locally optimal at
    each bond (Oseledets 2011, alg. 2).
    """
    cores = [jnp.asarray(g) for g in cores]
    d = len(cores)
    ranks = list(ranks)
    if len(ranks) != d - 1:
        raise ValueError(
            f"ranks must have {d - 1} entries for a {d}-core train, "
            f"got {len(ranks)}"
        )
    key = as_key(key)
    # right-to-left orthogonalization: G_k = R Q with Q row-orthonormal
    for k in range(d - 1, 0, -1):
        g = cores[k]
        r0, n, r1 = g.shape
        # LQ via QR of the transpose
        q, r = jnp.linalg.qr(g.reshape(r0, n * r1).T)
        q_rows = min(r0, n * r1)
        cores[k] = q.T.reshape(q_rows, n, r1)
        prev = cores[k - 1]
        cores[k - 1] = (
            _mm(prev.reshape(-1, r0), r.T)
            .reshape(prev.shape[0], prev.shape[1], q_rows)
        )
    # left-to-right truncation sweep
    for k in range(d - 1):
        g = cores[k]
        r0, n, r1 = g.shape
        r_new = min(ranks[k], r0 * n, r1)
        key, sub = jax.random.split(key)
        u, s, vt = _trunc_svd(g.reshape(r0 * n, r1), r_new, n_iters, sub)
        cores[k] = u.reshape(r0, n, r_new)
        carry = s[:, None] * vt                     # (r_new, r1)
        nxt = cores[k + 1]
        cores[k + 1] = (
            _mm(carry, nxt.reshape(r1, -1))
            .reshape(r_new, nxt.shape[1], nxt.shape[2])
        )
    return cores


def tt_dot(cores_a, cores_b):
    """Inner product <A, B> of two TT tensors with identical mode dims
    (ranks may differ) — O(sum n_k r^3), never densifies."""
    cores_a = [jnp.asarray(g) for g in cores_a]
    cores_b = [jnp.asarray(g) for g in cores_b]
    if len(cores_a) != len(cores_b):
        raise ValueError(
            f"trains differ in length: {len(cores_a)} vs {len(cores_b)}"
        )
    # v (ra, rb): running contraction of the leading modes
    v = jnp.ones((1, 1), dtype=cores_a[0].dtype)
    for ga, gb in zip(cores_a, cores_b):
        if ga.shape[1] != gb.shape[1]:
            raise ValueError(
                f"mode dims differ: {ga.shape[1]} vs {gb.shape[1]}"
            )
        # v' = sum_i ga[:, i, :]^T v gb[:, i, :]
        t = _mm(v, gb.reshape(gb.shape[0], -1))        # (ra, n*rb1)
        t = t.reshape(v.shape[0] * gb.shape[1], gb.shape[2])
        ga_mat = ga.reshape(ga.shape[0] * ga.shape[1], ga.shape[2])
        v = _mm(ga_mat.T, t)
    return v[0, 0]


def tt_norm(cores):
    """Frobenius norm of a TT tensor (sqrt of tt_dot with itself)."""
    return jnp.sqrt(jnp.maximum(tt_dot(cores, cores), 0.0))

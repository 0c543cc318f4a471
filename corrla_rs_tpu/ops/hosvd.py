"""Truncated higher-order SVD / Tucker decomposition (extension).

POD flattens multi-parameter snapshot families into one matrix; the
natural accelerator upgrade keeps the tensor structure: for a snapshot
tensor X (space x time x parameter x ...), the truncated HOSVD
(De Lathauwer, Moor & Vandewalle 2000) computes per-mode orthonormal
bases U_k from the mode-k unfoldings and a small core
G = X x_0 U_0^T x_1 U_1^T ..., giving X ~= G x_0 U_0 x_1 U_1 ... with
multilinear ranks (r_0, r_1, ...). ``hooi`` refines the bases by
alternating least squares (HOOI), which is optimal per mode given the
others.

Accelerator shape: every unfolding SVD is this library's randomized SVD
(the same sketch + power-iteration core PCA/POD/DMD compose — pass over
the big unfoldings as dense matmuls instead of dense LAPACK SVDs), and mode
products are single tensordots. Everything jits with static shapes.

No reference analogue (the reference is strictly matrix-shaped).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.ops.random_svd import random_svd
from corrla_rs_tpu.utils.prng import as_key

__all__ = ["hosvd", "hooi", "tucker_reconstruct", "mode_multiply"]


def _check_ranks(ranks, tensor) -> tuple:
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) != tensor.ndim:
        raise ValueError(
            f"ranks {ranks} must have one entry per tensor mode "
            f"({tensor.ndim})"
        )
    for k, (r, d) in enumerate(zip(ranks, tensor.shape)):
        if not 1 <= r <= d:
            raise ValueError(
                f"ranks[{k}]={r} must be in [1, {d}] (the mode-{k} "
                "dimension); the core is promised to have exactly the "
                "requested shape, so over-large ranks raise rather than "
                "silently clamp"
            )
    return ranks


def _unfold(t: jnp.ndarray, mode: int) -> jnp.ndarray:
    """Mode-k unfolding: (I_k, prod of the other dims)."""
    return jnp.moveaxis(t, mode, 0).reshape(t.shape[mode], -1)


def mode_multiply(t: jnp.ndarray, mat: jnp.ndarray, mode: int) -> jnp.ndarray:
    """Mode-k product t x_k mat: contracts t's mode-k axis with mat's
    SECOND axis (mat (J, I_k) maps axis size I_k -> J, staying at
    position ``mode``)."""
    moved = jnp.moveaxis(t, mode, -1)
    out = jnp.matmul(moved, mat.T, precision=PRECISION)
    return jnp.moveaxis(out, -1, mode)


def _factor(unf: jnp.ndarray, rank: int, n_iter: int, n_oversamples: int,
            key) -> jnp.ndarray:
    r = min(rank, unf.shape[0])
    u, _s, _vt = random_svd(unf, r, n_iter, n_oversamples, key=key)
    return u


@functools.partial(
    jax.jit, static_argnames=("ranks", "n_iter", "n_oversamples")
)
def hosvd(tensor: jnp.ndarray, ranks: tuple, n_iter: int = 8,
          n_oversamples: int = 8, key=0):
    """Truncated HOSVD: ``(core, factors)`` with ``core`` of shape
    ``ranks`` and ``factors[k]`` (I_k, r_k) orthonormal (mode-k left
    singular vectors of the unfolding, via randomized SVD).

    Exact when the tensor has multilinear rank <= ranks; otherwise the
    error is within sqrt(ndim) of the best rank-(r_0,...) approximation
    (the classic HOSVD quasi-optimality bound) — run ``hooi`` to tighten.
    """
    ranks = _check_ranks(ranks, tensor)
    keys = jax.random.split(as_key(key), tensor.ndim)
    factors = [
        _factor(_unfold(tensor, k), ranks[k], n_iter, n_oversamples,
                keys[k])
        for k in range(tensor.ndim)
    ]
    core = tensor
    for k, u in enumerate(factors):
        core = mode_multiply(core, u.T, k)
    return core, factors


@functools.partial(
    jax.jit, static_argnames=("ranks", "n_sweeps", "n_iter", "n_oversamples")
)
def hooi(tensor: jnp.ndarray, ranks: tuple, n_sweeps: int = 3,
         n_iter: int = 8, n_oversamples: int = 8, key=0):
    """Higher-order orthogonal iteration (Tucker-ALS): HOSVD init, then
    ``n_sweeps`` rounds updating each factor from the tensor with all
    OTHER modes projected (so each unfolding SVD runs on a small
    (I_k, prod r_j) matrix — cheaper AND more accurate than HOSVD's full
    unfoldings). Returns ``(core, factors)`` like ``hosvd``."""
    ranks = _check_ranks(ranks, tensor)
    # the ALS update SVDs an (I_k, prod of the OTHER ranks) matrix, so a
    # mode rank above that product is structurally unreachable (any
    # multilinear rank satisfies r_k <= prod_{j != k} r_j) — raise
    # instead of silently returning a smaller factor than requested
    import math as _math

    for k, r in enumerate(ranks):
        other = _math.prod(ranks[:k] + ranks[k + 1:])
        if r > other:
            raise ValueError(
                f"ranks[{k}]={r} exceeds prod(other ranks)={other}; every "
                "Tucker multilinear rank satisfies r_k <= prod of the "
                "others — lower it or raise the other ranks"
            )
    _core, factors = hosvd(tensor, ranks, n_iter=n_iter,
                           n_oversamples=n_oversamples, key=key)
    keys = jax.random.split(jax.random.fold_in(as_key(key), 1),
                            int(n_sweeps) * tensor.ndim)
    ki = 0
    for _sweep in range(int(n_sweeps)):
        for k in range(tensor.ndim):
            proj = tensor
            for j, u in enumerate(factors):
                if j != k:
                    proj = mode_multiply(proj, u.T, j)
            factors[k] = _factor(
                _unfold(proj, k), ranks[k], n_iter, n_oversamples, keys[ki]
            )
            ki += 1
    core = tensor
    for k, u in enumerate(factors):
        core = mode_multiply(core, u.T, k)
    return core, factors


@jax.jit
def tucker_reconstruct(core: jnp.ndarray, factors) -> jnp.ndarray:
    """X_hat = core x_0 U_0 x_1 U_1 ... — inverse of the compression."""
    out = core
    for k, u in enumerate(factors):
        out = mode_multiply(out, u, k)
    return out

"""CP (canonical polyadic / PARAFAC) decomposition by ALS — EXTENSION
(no reference analogue; completes the tensor-format family next to
Tucker/HOSVD (ops/hosvd) and tensor-train (ops/tt)).

CP writes a d-way tensor as a sum of R rank-one terms
T ~= sum_r lam_r a_r^(1) o ... o a_r^(d) — the UNIQUE (under Kruskal
conditions) latent-factor model, which Tucker/TT are not: CP factors
are interpretable axes (chemometrics, fluorescence, neural data).

Accelerator shape: each ALS update solves all R columns of one factor at
once from the matricized-tensor-times-Khatri-Rao product (MTTKRP). The
MTTKRP is computed WITHOUT materializing the Khatri-Rao matrix: fold
the factors in one at a time with batched matmuls/einsums; the
normal-equations Gram is the Hadamard product of the small R x R
factor Grams. Every sweep is one jitted function; fixed sweep count
(static shapes, no data-dependent control flow), fit history returned
for convergence inspection.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.utils.prng import as_key

__all__ = ["cp_als", "cp_reconstruct"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


def _mttkrp(t, factors, mode):
    """Matricized-tensor-times-Khatri-Rao along ``mode`` without
    forming the Khatri-Rao matrix: contract the tensor with every
    OTHER factor one axis at a time, keeping a trailing rank axis."""
    d = t.ndim
    others = [k for k in range(d) if k != mode]
    cur = jnp.transpose(t, [mode] + others)  # (I_mode, others...)
    # einsum always contracts the LAST tensor axis, so fold the other
    # factors in REVERSE axis order; the rank axis appears with the
    # first fold and rides along elementwise afterwards
    rev = others[::-1]
    cur = jnp.einsum("...j,jr->...r", cur, factors[rev[0]],
                     precision=PRECISION)
    for k in rev[1:]:
        cur = jnp.einsum("...jr,jr->...r", cur, factors[k],
                         precision=PRECISION)
    return cur                               # (I_mode, R)


@functools.partial(jax.jit, static_argnames=("n_sweeps",))
def _cp_sweeps(t, factors, n_sweeps):
    d = t.ndim
    eps = jnp.finfo(t.dtype).eps
    t_norm2 = jnp.sum(t * t)

    grams = [jnp.asarray(_mm(f.T, f)) for f in factors]

    def sweep(carry, _):
        factors, grams = carry
        for mode in range(d):
            g = jnp.ones_like(grams[0])
            for k in range(d):
                if k != mode:
                    g = g * grams[k]
            m = _mttkrp(t, factors, mode)            # (I_mode, R)
            # ridge well above roundoff: over-ranked fits drive factor
            # columns collinear and make the Hadamard Gram numerically
            # singular; eps-scale regularization lets solve emit NaN
            reg = 100.0 * eps * jnp.trace(g) / g.shape[0] + eps
            f_new = jnp.linalg.solve(
                g + reg * jnp.eye(g.shape[0], dtype=t.dtype), m.T
            ).T
            factors = [f_new if k == mode else factors[k]
                       for k in range(d)]
            grams = [(_mm(f_new.T, f_new) if k == mode else grams[k])
                     for k in range(d)]
        # fit = 1 - ||T - That|| / ||T|| via the inner-product identity
        g_all = jnp.ones_like(grams[0])
        for k in range(d):
            g_all = g_all * grams[k]
        m_last = _mttkrp(t, factors, d - 1)
        inner = jnp.sum(m_last * factors[d - 1])
        that2 = jnp.sum(g_all)
        err2 = jnp.maximum(t_norm2 - 2.0 * inner + that2, 0.0)
        fit = 1.0 - jnp.sqrt(err2 / t_norm2)
        return (factors, grams), fit

    (factors, _), fits = jax.lax.scan(
        sweep, (factors, grams), None, length=n_sweeps
    )
    return factors, fits


def cp_als(tensor, rank: int, n_sweeps: int = 50, key=0,
           init: str = "svd", mesh=None):
    """Rank-``rank`` CP/PARAFAC fit of a d-way tensor by ALS.

    init: 'svd' (default — factors start from each unfolding's leading
    left singular vectors, the standard swamp-avoiding initialization;
    random init can stall in local minima) or 'random'.

    mesh: optional 1-D jax.sharding.Mesh — the tensor is sharded along
    axis 0 (the tall snapshot/sample mode) and factor 0 rides the same
    sharding. Mode-0 MTTKRP stays device-local; every other mode's
    MTTKRP contracts the sharded axis, so GSPMD inserts one psum of an
    (I_k, R) partial per update — the small R x R Hadamard-Gram solves
    replicate. Same psum-Gram contract as parallel/sharded_hosvd.py
    (SURVEY §2.2).

    Returns (weights, factors, fits): ``weights`` (R,) positive scales
    (factors column-normalized, largest component first), ``factors``
    list of (I_k, R) matrices, ``fits`` (n_sweeps,) the fit history
    1 - ||T - T_hat||/||T|| (monotone up to roundoff; inspect to judge
    convergence). Reconstruction via :func:`cp_reconstruct`.
    """
    t = jnp.asarray(tensor)
    if t.ndim < 2:
        raise ValueError(f"tensor must be >= 2-way, got {t.ndim}-way")
    r = int(rank)
    if r < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    if init not in ("svd", "random"):
        raise ValueError(f"init must be 'svd' or 'random', got {init!r}")
    if not bool(jnp.any(t != 0)):
        # a zero tensor would divide the fit by ||T|| = 0 -> NaN
        zeros = [jnp.zeros((int(t.shape[k]), r), t.dtype)
                 for k in range(t.ndim)]
        return (jnp.zeros((r,), t.dtype), zeros,
                jnp.ones((int(n_sweeps),), t.dtype))
    keys = jax.random.split(as_key(key), t.ndim)
    if init == "random":
        factors = [
            jax.random.normal(keys[k], (int(t.shape[k]), r),
                              dtype=t.dtype)
            for k in range(t.ndim)
        ]
    else:
        from corrla_rs_tpu.ops.random_svd import random_svd

        factors = []
        for k in range(t.ndim):
            i_k = int(t.shape[k])
            unf = jnp.moveaxis(t, k, 0).reshape(i_k, -1)
            r_k = min(r, i_k, int(unf.shape[1]))
            u, _, _ = random_svd(unf, r_k, 4, min(8, i_k), key=keys[k])
            if r_k < r:  # pad narrow modes with random columns
                pad = jax.random.normal(
                    jax.random.fold_in(keys[k], 1), (i_k, r - r_k),
                    dtype=t.dtype,
                )
                u = jnp.concatenate([u, pad], axis=1)
            factors.append(u)
    if mesh is not None:
        from corrla_rs_tpu.parallel.mesh import shard_rows

        t = shard_rows(t, mesh)
        factors = [shard_rows(factors[0], mesh)] + factors[1:]
    factors, fits = _cp_sweeps(t, factors, int(n_sweeps))
    # normalize: push column norms into weights, sort descending
    norms = [jnp.linalg.norm(f, axis=0) for f in factors]
    weights = np.ones(r)
    for nvec in norms:
        weights = weights * np.asarray(nvec, np.float64)
    factors = [np.asarray(f, np.float64)
               / np.maximum(np.asarray(nv, np.float64), 1e-300)[None, :]
               for f, nv in zip(factors, norms)]
    order = np.argsort(-weights)
    weights = weights[order]
    factors = [jnp.asarray(f[:, order], t.dtype) for f in factors]
    return jnp.asarray(weights, t.dtype), factors, fits


def cp_reconstruct(weights, factors):
    """Dense tensor from a CP model: sum_r w_r outer(a_r^(1), ...).

    Accumulates rank-one terms under lax.scan so peak memory is
    O(output), not O(output * R) (a (..., R) intermediate would be R
    times the output tensor)."""
    d = len(factors)
    w = jnp.asarray(weights)
    cols = tuple(jnp.asarray(f).T for f in factors)   # each (R, I_k)
    shape = tuple(int(f.shape[1]) for f in cols)

    def add_term(acc, xs):
        wr, vecs = xs
        term = vecs[0]
        for k in range(1, d):
            term = term[..., None] * vecs[k]
        return acc + wr * term, None

    acc0 = jnp.zeros(shape, cols[0].dtype)
    acc, _ = jax.lax.scan(add_term, acc0, (w, cols))
    return acc

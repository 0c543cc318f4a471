"""Multi-chip randomized SVD: row-sharded A over a device mesh.

The north-star speed lever (SURVEY.md §7 stage 4). The tall matrix A
(n, m) is sharded along its row axis across the mesh; per power iteration:

    Y_l   = A_l @ Omega                       (local dense matmul)
    Z     = psum_rows(A_l^T @ Y_l)            (Gram reduction over the interconnect)
    Y_l   = A_l @ Z                           (local dense matmul)

The in-loop distributed thin-QR is the preconditioned ridge-fallback
CholeskyQR (three rounds of psum'd column norms + Gram, Cholesky with
small/large ridge select — see ops.random_svd._cholesky_qr2) —
communication is two k x k psums per round, tiny next to the local FLOPs.
The FINAL orthonormalization is an exact distributed TSQR (``_tsqr``):
local Householder panels + one replicated QR of the gathered R stack —
backward stable, so the multi-chip path holds the same f32 sigma-parity
bar (< 1e-6) as the single-chip Householder final QR.

The small B = psum(Q_l^T A_l) SVD is replicated on every chip
(k x m with k = rank + oversamples).

Matches single-device ``random_svd`` semantics (same sketch for the same
key; oracle parity tests assert agreement on a faked multi-device CPU
backend).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.ops.random_svd import sigma_values
from corrla_rs_tpu.parallel.mesh import make_mesh, row_sharding
from corrla_rs_tpu.utils.prng import as_key

__all__ = ["sharded_random_svd", "sharded_power_iter_qr"]


def _chol_qr_once(y_l, axis_name, eps_small, eps_big, tiny):
    """One preconditioned CholeskyQR round (ridge fallback) on a
    row-sharded matrix — the distributed twin of
    ops.random_svd._cholesky_qr2's round: column norms and the Gram are
    psum-reduced over the mesh axis; everything else is local."""
    k = y_l.shape[1]
    dtype = y_l.dtype
    cn2 = lax.psum(jnp.sum(y_l * y_l, axis=0), axis_name)
    cn = jnp.maximum(jnp.sqrt(cn2), tiny)
    ys_l = y_l / cn[None, :]
    g = lax.psum(jnp.matmul(ys_l.T, ys_l, precision=PRECISION), axis_name)
    eye = jnp.eye(k, dtype=dtype)
    r_small = jnp.linalg.cholesky(g + eps_small * eye, upper=True)
    ok = jnp.all(jnp.isfinite(r_small))
    r_big = jnp.linalg.cholesky(g + eps_big * eye, upper=True)
    r = jnp.where(ok, r_small, r_big)
    return lax.linalg.triangular_solve(r, ys_l, left_side=False, lower=False)


def _chol_qr2(y_l, axis_name, dtype):
    """Three robust rounds — see ops.random_svd._cholesky_qr2 for the
    rationale (rank-deficient sketches, f32 Gram rounding)."""
    if dtype == jnp.float32:
        eps_small, eps_big, tiny = 1e-7, 1e-2, 1e-30
    else:
        eps_small, eps_big, tiny = 1e-15, 1e-8, 1e-290
    tiny = jnp.asarray(tiny, dtype)
    for _ in range(3):
        y_l = _chol_qr_once(y_l, axis_name, eps_small, eps_big, tiny)
    return y_l


def _tsqr(y_l, axis_name):
    """Distributed exact thin QR (one-level TSQR).

    Local Householder QR of each shard's (n_local, k) panel, ``all_gather``
    of the k x k R factors, one replicated Householder QR of the stacked
    (n_dev*k, k) R, then a local combine Q_l @ Q_r[shard block]. Backward
    stable like Householder (unlike CholeskyQR2's ridge fallback), so it is
    the FINAL orthonormalization of the sharded range finder — the same
    rule the single-chip path applies (ops.random_svd.power_iter: the final
    QR alone determines B = Q^T A and every sigma downstream).
    Communication: one k x k all_gather; the stacked-R QR is replicated
    (n_dev*k x k — trivial next to the sharded matmuls).
    """
    k = y_l.shape[1]
    q_l, r_l = jnp.linalg.qr(y_l, mode="reduced")
    r_all = lax.all_gather(r_l, axis_name, tiled=True)
    q_r = jnp.linalg.qr(r_all, mode="reduced")[0]
    idx = lax.axis_index(axis_name)
    q_r_block = lax.dynamic_slice_in_dim(q_r, idx * k, k)
    return jnp.matmul(q_l, q_r_block, precision=PRECISION)


def _power_iter_sharded(a_l, omega, n_iter, stabilize, axis_name):
    """Row-sharded randomized range finder; returns row-sharded Q_l."""
    dtype = a_l.dtype
    y_l = jnp.matmul(a_l, omega, precision=PRECISION)

    def body(i, y_l):
        if stabilize == "always":
            y_l = _chol_qr2(y_l, axis_name, dtype)
        else:
            y_l = lax.cond(
                i > 2,
                lambda q: _chol_qr2(q, axis_name, dtype),
                lambda q: q,
                y_l,
            )
        z = lax.psum(jnp.matmul(a_l.T, y_l, precision=PRECISION), axis_name)
        y_l = jnp.matmul(a_l, z, precision=PRECISION)
        norm2 = lax.psum(jnp.sum(y_l * y_l), axis_name)
        y_l = y_l / jnp.maximum(jnp.sqrt(norm2), jnp.asarray(1e-30, dtype))
        return y_l

    y_l = lax.fori_loop(0, n_iter, body, y_l)
    return _tsqr(y_l, axis_name)


def sharded_power_iter_qr(a_l, omega, n_iter, stabilize, axis_name):
    """shard_map-callable randomized range finder (exported for reuse)."""
    return _power_iter_sharded(a_l, omega, n_iter, stabilize, axis_name)


@functools.partial(
    jax.jit,
    static_argnames=(
        "omega_rank", "n_iter", "n_oversamples", "stabilize", "mesh",
        "axis_name",
    ),
)
def _sharded_rsvd_jit(a, omega_rank, n_iter, n_oversamples, key, stabilize,
                      mesh, axis_name):
    n, m = a.shape
    sketch_rank = min(omega_rank + n_oversamples, m)
    rank = min(omega_rank, sketch_rank)
    omega = jax.random.normal(as_key(key), (m, sketch_rank), dtype=a.dtype)

    def kernel(a_l, omega):
        q_l = _power_iter_sharded(a_l, omega, n_iter, stabilize, axis_name)
        b = lax.psum(jnp.matmul(q_l.T, a_l, precision=PRECISION), axis_name)
        u_b, _s, vt = jnp.linalg.svd(b, full_matrices=False)
        s = sigma_values(b)  # see ops.random_svd.sigma_values
        u_l = jnp.matmul(q_l, u_b, precision=PRECISION)
        return u_l, s, vt

    u, s, vt = jax.shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(axis_name, None), P()),
        out_specs=(P(axis_name, None), P(), P()),
    )(a, omega)
    return u[:, :rank], s[:rank], vt[:rank, :]


def sharded_random_svd(a, omega_rank: int, n_iter: int, n_oversamples: int,
                       key=0, stabilize: str = "always", mesh=None,
                       axis_name: str | None = None):
    """Randomized SVD of a tall row-sharded matrix over a device mesh.

    Args:
      a: (n, m) with n >= m, n divisible by mesh size. Will be placed
         row-sharded if not already.
      stabilize: 'always' (default here — CholeskyQR2 is cheap relative to
         the sharded matmuls and much safer in f32) or 'reference'.
      mesh: 1-D jax.sharding.Mesh; defaults to all devices.
    Returns:
      (U (n, r) row-sharded, s (r,), Vt (r, m)) — identical semantics to
      ops.random_svd.random_svd for the same key, modulo fp reduction order.
    """
    mesh = mesh or make_mesh()
    axis_name = axis_name or mesh.axis_names[0]
    a = jnp.asarray(a)
    n_dev = mesh.shape[axis_name]
    if a.shape[0] < a.shape[1]:
        raise ValueError(
            "sharded_random_svd expects a tall (n >= m) matrix; transpose "
            "fat inputs at the caller (layout choice)"
        )
    if a.shape[0] % n_dev != 0:
        raise ValueError(
            f"rows ({a.shape[0]}) must divide the mesh axis size ({n_dev})"
        )
    a = jax.device_put(a, row_sharding(mesh, axis_name))
    return _sharded_rsvd_jit(
        a, omega_rank, n_iter, n_oversamples, as_key(key), stabilize, mesh,
        axis_name,
    )

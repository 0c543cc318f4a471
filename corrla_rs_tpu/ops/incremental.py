"""Incremental (online) truncated SVD and PCA — EXTENSION.

The reference refits from scratch when data arrives (its models hold
fitted faer matrices with no update path, pca_rsvd.rs:56-82); production
streams append snapshots/samples continuously, and a refit costs a full
RSVD over all data seen so far. This module maintains a rank-r
factorization under appends in O(n r^2 + n r c) per batch of c new
columns — independent of how many columns have ever been absorbed:

- ``IncrementalSvd``: Brand (2002/2006) incremental SVD. State is
  (U (n, r), s (r,), V (m_seen, r)); ``update(C)`` absorbs new columns
  by projecting onto the current range, QR-ing the residual, and
  re-diagonalizing a small ((r+c), (r+c)) core matrix. Exact (fp-level)
  whenever the data's true rank stays <= r; otherwise the optimal
  truncation of the augmented factorization at each step (the standard
  online-truncation greedy).
- ``IncrementalPca``: Ross/Lim/Lin/Yang (2008) mean-corrected
  incremental PCA over row batches (sklearn ``partial_fit`` semantics,
  matching this library's PCA layout: samples are rows, components are
  rows of Vt). The running mean shift is absorbed as one extra rank-1
  correction column per batch.

Accelerator notes: each update is ONE jitted kernel (projection matmuls,
a reduced Householder QR of the (n, c) residual, an eigh-free small SVD
as dense matmuls) with static shapes per (n, r, c) — repeated same-size
batches reuse one compiled executable. State lives on device; nothing
scales with the number of absorbed batches.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.mat_utils import PRECISION

__all__ = ["IncrementalSvd", "IncrementalPca"]


@functools.partial(jax.jit, static_argnames=("rank",))
def _brand_update_cols(u, s, c_new, rank):
    """One Brand column-append step on (U, s) — V handled by the caller
    (it only grows; the rotation applied to it is returned).

    Returns (u_new (n, r), s_new (r,), rot_old (r, r+? -> r), rot_new
    (c, r)): V_new = [[V @ rot_old], [rot_new]] stacked by the caller.
    """
    mm = functools.partial(jnp.matmul, precision=PRECISION)
    r = u.shape[1]
    ell = mm(u.T, c_new)                     # (r, c)
    h = c_new - mm(u, ell)                   # residual (n, c)
    q_h, r_h = jnp.linalg.qr(h, mode="reduced")   # (n, c), (c, c)
    # core K = [[diag(s), L], [0, R_H]]; R_H is (min(n, c), c) — the
    # residual column space cannot exceed n rows
    k = jnp.block([
        [jnp.diag(s), ell],
        [jnp.zeros((r_h.shape[0], r), u.dtype), r_h],
    ])
    u_k, s_k, vt_k = jnp.linalg.svd(k, full_matrices=False)
    u_new = mm(jnp.concatenate([u, q_h], axis=1), u_k[:, :rank])
    v_k = vt_k.T                              # (r+c, r+c)
    return u_new, s_k[:rank], v_k[:r, :rank], v_k[r:, :rank]


class IncrementalSvd:
    """Rank-r truncated SVD of a column-growing matrix A = [C_1, C_2, ...].

    ``update(C)`` absorbs a new (n, c) column batch; ``u``/``s``/``v``
    expose the current factorization (A ~= U diag(s) V^T with V over all
    columns seen). ``track_v=False`` drops V (row space) for memory-free
    absorption of unbounded streams (POD modes / PCA components only
    need the left factors here).
    """

    def __init__(self, rank: int, track_v: bool = True):
        self.rank = int(rank)
        self.track_v = bool(track_v)
        self.u = None
        self.s = None
        self.v = None
        self.n_cols = 0

    def update(self, c_new) -> "IncrementalSvd":
        c_new = jnp.asarray(c_new)
        if c_new.ndim == 1:
            c_new = c_new[:, None]
        n, c = c_new.shape
        if self.u is None:
            # bootstrap: thin SVD of the first batch
            u0, s0, vt0 = jnp.linalg.svd(c_new, full_matrices=False)
            r = min(self.rank, min(n, c))
            self.u, self.s = u0[:, :r], s0[:r]
            if self.track_v:
                self.v = vt0.T[:, :r]
            self.n_cols = c
            return self
        if n != self.u.shape[0]:
            raise ValueError(
                f"new columns have {n} rows, state has {self.u.shape[0]}"
            )
        r_cur = self.u.shape[1]
        r_next = min(self.rank, r_cur + c)
        u, s, rot_old, rot_new = _brand_update_cols(
            self.u, self.s, c_new, r_next
        )
        self.u, self.s = u, s
        if self.track_v:
            mm = functools.partial(jnp.matmul, precision=PRECISION)
            self.v = jnp.concatenate([mm(self.v, rot_old), rot_new], axis=0)
        self.n_cols += c
        return self

    def reconstruct(self) -> jnp.ndarray:
        """U diag(s) V^T over all absorbed columns (requires track_v)."""
        if self.v is None:
            raise ValueError("track_v=False discarded the row space")
        return jnp.matmul(self.u * self.s[None, :], self.v.T,
                          precision=PRECISION)


@functools.partial(jax.jit, static_argnames=("rank",))
def _ipca_update_kernel(components, svals, mean, n_seen, x_batch, rank):
    """Mean-corrected row-batch PCA update (Ross et al. 2008 sec. 3.1,
    transposed to samples-as-rows): the change of mean enters as ONE
    virtual row sqrt(n*c/(n+c)) (mean_old - mean_batch) appended to the
    centered batch; then a Brand step on the transposed factorization.
    """
    mm = functools.partial(jnp.matmul, precision=PRECISION)
    c = x_batch.shape[0]
    mean_b = jnp.mean(x_batch, axis=0)
    xc = x_batch - mean_b[None, :]
    corr = jnp.sqrt(n_seen * c / (n_seen + c)) * (mean - mean_b)
    rows = jnp.concatenate([xc, corr[None, :]], axis=0)   # (c+1, d)
    mean_new = (n_seen * mean + c * mean_b) / (n_seen + c)
    # Brand on columns of A^T: current left factors are the components^T
    w = components.T                                      # (d, r)
    ell = mm(w.T, rows.T)                                 # (r, c+1)
    h = rows.T - mm(w, ell)
    q_h, r_h = jnp.linalg.qr(h, mode="reduced")
    k = jnp.block([
        [jnp.diag(svals), ell],
        [jnp.zeros((r_h.shape[0], svals.shape[0]), rows.dtype), r_h],
    ])
    u_k, s_k, _vt_k = jnp.linalg.svd(k, full_matrices=False)
    w_new = mm(jnp.concatenate([w, q_h], axis=1), u_k[:, :rank])
    return w_new.T, s_k[:rank], mean_new


class IncrementalPca:
    """Online PCA with running mean (sklearn ``IncrementalPCA``
    semantics; this library's layout: components_ rows are directions).

    ``partial_fit(X)`` absorbs an (n_batch, d) row batch in one jitted
    dispatch; ``components_`` / ``singular_values_`` / ``mean_`` /
    ``explained_variance_`` match a batch PCA of all absorbed rows
    exactly when the data rank stays <= n_components, and the standard
    online-truncation greedy approximation otherwise.
    """

    def __init__(self, n_components: int):
        self.n_components = int(n_components)
        self.components_ = None
        self.singular_values_ = None
        self.mean_ = None
        self.n_samples_seen_ = 0

    def partial_fit(self, x) -> "IncrementalPca":
        x = jnp.asarray(x)
        if x.ndim != 2:
            raise ValueError(f"expected (n, d) batch, got {x.shape}")
        n_b, d = x.shape
        if self.components_ is None:
            mean = jnp.mean(x, axis=0)
            _u, s, vt = jnp.linalg.svd(x - mean[None, :],
                                       full_matrices=False)
            r = min(self.n_components, min(n_b, d))
            self.components_ = vt[:r]
            self.singular_values_ = s[:r]
            self.mean_ = mean
            self.n_samples_seen_ = n_b
            return self
        if d != self.components_.shape[1]:
            raise ValueError(
                f"batch has {d} features, state has "
                f"{self.components_.shape[1]}"
            )
        r_next = min(self.n_components,
                     self.components_.shape[0] + n_b + 1)
        self.components_, self.singular_values_, self.mean_ = (
            _ipca_update_kernel(
                self.components_, self.singular_values_, self.mean_,
                float(self.n_samples_seen_), x, r_next,
            )
        )
        self.n_samples_seen_ += n_b
        return self

    @property
    def explained_variance_(self):
        return self.singular_values_ ** 2 / max(self.n_samples_seen_ - 1, 1)

    def transform(self, x) -> jnp.ndarray:
        x = jnp.asarray(x)
        return jnp.matmul(x - self.mean_[None, :], self.components_.T,
                          precision=PRECISION)

    def inverse_transform(self, z) -> jnp.ndarray:
        z = jnp.asarray(z)
        return jnp.matmul(z, self.components_, precision=PRECISION) + \
            self.mean_[None, :]

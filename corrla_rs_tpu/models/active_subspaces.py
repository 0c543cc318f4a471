"""Active-subspace identification + Constantine-Diaz sensitivity.

Ref: P. Constantine et al., "Active subspace methods in theory and
practice" (arxiv 1304.2070); Constantine & Diaz, "Global sensitivity
metrics from active subspaces" (arxiv 1510.04361).

Parity with reference active_subspaces.rs:23-277 — with the accelerator
replacements from SURVEY.md §2 row 6:

- The reference's KdTree neighbor search (active_subspaces.rs:71-77,90-112)
  becomes a batched on-device kNN (pairwise distances + ``lax.top_k``).
- The reference's *serial* per-sample gradient loop
  (``create_grad_mat``, active_subspaces.rs:215-229) becomes a single
  vmapped local least-squares over all N samples.
- The ``fit`` path's eigendecomposition (active_subspaces.rs:252-277) uses
  ``jnp.linalg.eigh`` — C = G G^T / N is symmetric PSD, so the symmetric
  solver applies (the reference calls a complex general EVD and
  discards the zero imaginary parts, active_subspaces.rs:260-267).
- The ``fit_svd`` path (active_subspaces.rs:233-250) uses the shared RSVD
  core with the reference defaults (8 iters / 10 oversamples).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from corrla_rs_tpu.ops.knn import knn
from corrla_rs_tpu.ops.mat_utils import PRECISION, sort_evd
from corrla_rs_tpu.ops.random_svd import random_svd
from corrla_rs_tpu.ops.stats_corr import jac_from_lin, jac_from_quad, quad_fit
from corrla_rs_tpu.utils.config import ActiveSsConfig
from corrla_rs_tpu.utils.prng import as_key

# Reference defaults for fit_svd (active_subspaces.rs:243).
# Single source of truth: utils.config.
ASS_N_ITER = ActiveSsConfig().n_iter
ASS_N_OVERSAMPLES = ActiveSsConfig().n_oversamples


@functools.partial(jax.jit, static_argnames=("est_order",))
def local_poly_grads(x_nbr, y_nbr, x_query, est_order: int) -> jnp.ndarray:
    """Vmapped local polynomial gradient fits over gathered neighborhoods.

    x_nbr: (n_q, n_nbrs, k), y_nbr: (n_q, n_nbrs, 1), x_query: (n_q, k).
    """
    if est_order == 1:
        def one(xn, yn, _x0):
            return jac_from_lin(xn, yn)[0]
    elif est_order == 2:
        def one(xn, yn, x0):
            coeffs = quad_fit(xn, yn)
            return jac_from_quad(x0[None, :], coeffs)[0]
    else:
        raise NotImplementedError(f"Not implemented est order: {est_order}")

    return jax.vmap(one)(x_nbr, y_nbr, x_query)


@functools.partial(
    jax.jit,
    static_argnames=("est_order", "n_nbrs", "query_chunk", "support_chunk"),
)
def batched_grad_est(x_support, y_support, x_query, est_order: int,
                     n_nbrs: int, query_chunk: int | None = None,
                     support_chunk: int | None = None) -> jnp.ndarray:
    """Gradient estimates [dy/dx_1 .. dy/dx_k] at each query row.

    One kNN + one vmapped local polynomial fit — the batched equivalent of
    the reference's per-point ``grad_at`` (active_subspaces.rs:52-62,
    115-140). Returns (n_query, k). ``query_chunk``/``support_chunk``
    bound the kNN distance-matrix memory at (query_chunk, support_chunk)
    for large point clouds (SURVEY.md §7 hard part 5: streaming tiles +
    running top-k merge instead of the KdTree).
    """
    _d, idx = knn(x_query, x_support, n_nbrs, query_chunk=query_chunk,
                  support_chunk=support_chunk)
    x_nbr = x_support[idx]            # (n_q, n_nbrs, k)
    y_nbr = y_support[idx]            # (n_q, n_nbrs, 1)
    return local_poly_grads(x_nbr, y_nbr, x_query, est_order)


class PolyGradientEstimator:
    """Local-polynomial gradient estimator over a point cloud.

    Mirrors PolyGradientEstimator (active_subspaces.rs:23-141) with the
    KdTree replaced by batched dense kNN. est_order 1 = local hyperplane,
    2 = local quadratic.
    """

    def __init__(self, x_mat, y, est_order: int, n_nbrs: int,
                 query_chunk: int | None = None,
                 support_chunk: int | None = None, backend: str = "device"):
        self.query_chunk = query_chunk
        self.support_chunk = support_chunk
        self.x_mat = jnp.asarray(x_mat)
        self.y = jnp.asarray(y)
        if self.y.ndim == 1:
            self.y = self.y[:, None]
        self.k = self.x_mat.shape[1]
        self.est_order = int(est_order)
        self.n_nbrs = int(n_nbrs)
        n = self.x_mat.shape[0]
        # sample-count guards, parity with active_subspaces.rs:118-119,129-130
        if self.est_order == 1:
            need = self.k + 1
        else:
            need = self.k * (self.k + 3) // 2
        assert n > need, f"need > {need} samples for order {self.est_order}"
        assert self.n_nbrs > need, f"need n_nbrs > {need}"
        # backend='native': exact C++ kd-tree kNN on host (O(n log n) per
        # query vs the device's O(n) dense pass) + device-vmapped local
        # fits. Wins when the support cloud is huge; the device path stays
        # fully jittable/shardable and is the default.
        self.backend = backend
        if backend == "native":
            from corrla_rs_tpu.native import KdTreeHost

            self._tree = KdTreeHost(self.x_mat)
        elif backend != "device":
            raise ValueError(f"unknown backend {backend!r}")

    def grad_at(self, x0) -> jnp.ndarray:
        """Gradient row (1, k) at a single point. active_subspaces.rs:52-62."""
        x0 = jnp.asarray(x0, self.x_mat.dtype).reshape(1, -1)
        return self.grad_batch(x0)

    def grad_batch(self, x_query) -> jnp.ndarray:
        """Gradients at many points at once: (n_query, k)."""
        xq = jnp.asarray(x_query)
        if self.backend == "native":
            import numpy as np

            _d, idx = self._tree.query(np.asarray(xq), self.n_nbrs)
            idx = jnp.asarray(idx)
            return local_poly_grads(
                self.x_mat[idx], self.y[idx], xq, self.est_order
            )
        return batched_grad_est(
            self.x_mat, self.y, xq, self.est_order,
            self.n_nbrs, self.query_chunk, self.support_chunk,
        )


class AdGradientEstimator:
    """EXACT gradients via ``jax.grad`` — the estimator the reference
    could never have (Rust, no autodiff; its PolyGradientEstimator
    exists purely to APPROXIMATE gradients from samples,
    active_subspaces.rs:23-141). When the model is a jax-traceable
    callable f: (k,) -> scalar, this is a drop-in ``grad_est`` for
    ActiveSsRsvd with zero estimation error, no kNN support cloud and
    no sample-count requirements: one vmapped reverse-mode pass per
    query batch."""

    def __init__(self, fn):
        import jax as _jax

        self.fn = fn
        self._grad1 = _jax.grad(fn)
        self._gradn = _jax.vmap(self._grad1)

    def grad_at(self, x0) -> jnp.ndarray:
        return self._grad1(jnp.asarray(x0)).reshape(1, -1)

    def grad_batch(self, x_query) -> jnp.ndarray:
        return self._gradn(jnp.asarray(x_query))


class FittedActiveSsRsvd:
    """Fitted active subspace. Mirrors FittedActiveSsRsvd
    (active_subspaces.rs:45-198)."""

    def __init__(self, components, singular_vals, n_comps: int):
        self.components_ = components          # (k, r_full) columns
        self.singular_vals_ = singular_vals    # (r_full, r_full) diag
        self.n_comps = int(n_comps)

    @property
    def components(self) -> jnp.ndarray:
        """First n_comps component columns. active_subspaces.rs:190-192."""
        return self.components_[:, : self.n_comps]

    @property
    def singular_vals(self) -> jnp.ndarray:
        """First n_comps columns of the diag matrix. active_subspaces.rs:195-197."""
        return self.singular_vals_[:, : self.n_comps]

    def var_diag_evd_sensi(self) -> jnp.ndarray:
        """Constantine-Diaz eq. 22 sensitivity, parity formula.

        Reproduces the reference exactly (active_subspaces.rs:160-170):
        diag(W^T Lambda W). NOTE the reference applies the transpose to the
        *first* factor; the textbook activity score is diag(W Lambda W^T)
        — available as ``activity_scores`` below. SURVEY.md §2.4 item 11.
        """
        w = self.components_
        m = jnp.matmul(
            jnp.matmul(w.T, self.singular_vals_, precision=PRECISION),
            w, precision=PRECISION,
        )
        return jnp.diagonal(m)

    def activity_scores(self) -> jnp.ndarray:
        """diag(W Lambda W^T) — the textbook Constantine-Diaz metric."""
        w = self.components_
        m = jnp.matmul(
            jnp.matmul(w, self.singular_vals_, precision=PRECISION),
            w.T, precision=PRECISION,
        )
        return jnp.diagonal(m)

    def transform(self, x_mat) -> jnp.ndarray:
        """Project (n, k) data onto the active subspace. active_subspaces.rs:173-179."""
        return jnp.matmul(jnp.asarray(x_mat), self.components, precision=PRECISION)

    def inv_transform(self, x_red) -> jnp.ndarray:
        """Map reduced (n, r) data back to (n, k). active_subspaces.rs:182-187."""
        x_red = jnp.asarray(x_red)
        assert x_red.shape[1] == self.n_comps
        return jnp.matmul(x_red, self.components.T, precision=PRECISION)


class ActiveSsRsvd:
    """Active-subspace estimator. Mirrors ActiveSsRsvd
    (active_subspaces.rs:201-277)."""

    def __init__(self, grad_est, n_comps: int):
        self.grad_est = grad_est
        self.n_comps = int(n_comps)

    def create_grad_mat(self, x_mat) -> jnp.ndarray:
        """(k, N) gradient matrix, one column per sample — batched (the
        reference loops serially, active_subspaces.rs:215-229)."""
        grads = self.grad_est.grad_batch(jnp.asarray(x_mat))  # (N, k)
        return grads.T

    def _shard_queries(self, x, mesh):
        """Row-shard the query/sample axis over the mesh. The gradient
        estimation is embarrassingly parallel over queries (support points
        stay replicated); GSPMD partitions the vmapped local fits and
        inserts the psum for the cross-shard G G^T / RSVD Gram reductions.
        """
        from corrla_rs_tpu.parallel.mesh import shard_rows

        if x.shape[0] % mesh.devices.size != 0:
            raise ValueError(
                f"active-subspace mesh= requires the sample count "
                f"({x.shape[0]}) to divide the mesh size "
                f"({mesh.devices.size})"
            )
        return shard_rows(x, mesh)

    def fit(self, x_mat, mesh=None) -> FittedActiveSsRsvd:
        """EVD path: eigh of C = G G^T / N, sorted descending.

        Parity with active_subspaces.rs:252-277 (C is symmetric PSD so the
        native symmetric solver replaces the reference's complex
        general EVD whose imaginary parts are zero).

        ``mesh=``: shard the N sample/query axis across chips — per-shard
        kNN + local fits, psum'd C reduction (SURVEY.md §2.2 long-axis
        scaling for component 6).
        """
        x = jnp.asarray(x_mat)
        if mesh is not None:
            x = self._shard_queries(x, mesh)
        g = self.create_grad_mat(x)
        c = jnp.matmul(g, g.T, precision=PRECISION) / x.shape[0]
        eigs, eigvs = jnp.linalg.eigh(c)
        sorted_vals, sorted_vecs = sort_evd(eigs, eigvs)
        return FittedActiveSsRsvd(sorted_vecs, sorted_vals, self.n_comps)

    def fit_bootstrap(self, x_mat, n_boot: int = 100, key=0, mesh=None):
        """Bootstrap intervals for the active-subspace eigenvalues and the
        subspace estimate (Constantine, "Active Subspace Methods", 2015,
        ch. 3 practice — the reference has no uncertainty story at all).

        Resamples the N gradient columns with replacement ``n_boot`` times;
        each replicate's C = G_b G_b^T / N eigendecomposition runs as one
        vmapped ``eigh`` (all replicates in a single device dispatch).

        Returns a dict with:
          eig_lo / eig_hi: 2.5 / 97.5 percentile eigenvalue bands (k,)
          eigs: point-estimate eigenvalues (k,)
          subspace_dist: (n_boot,) spectral-norm distances
            ||W W^T - W_b W_b^T||_2 between each replicate's leading
            n_comps subspace and the point estimate — the Constantine
            diagnostic for choosing the subspace dimension.
        """
        x = jnp.asarray(x_mat)
        if mesh is not None:
            x = self._shard_queries(x, mesh)
        g = self.create_grad_mat(x)                   # (k, N)
        n = g.shape[1]
        n_comps = self.n_comps

        c0 = jnp.matmul(g, g.T, precision=PRECISION) / n
        eigs0, vecs0 = jnp.linalg.eigh(c0)
        vals0, w0 = sort_evd(eigs0, vecs0)
        w0 = w0[:, :n_comps]

        idx = jax.random.randint(as_key(key), (int(n_boot), n), 0, n)

        def one(ix):
            gb = g[:, ix]
            cb = jnp.matmul(gb, gb.T, precision=PRECISION) / n
            eb, vb = jnp.linalg.eigh(cb)
            vals_b, w_b = sort_evd(eb, vb)
            proj = (
                jnp.matmul(w0, w0.T, precision=PRECISION)
                - jnp.matmul(
                    w_b[:, :n_comps], w_b[:, :n_comps].T, precision=PRECISION
                )
            )
            dist = jnp.linalg.norm(proj, ord=2)
            return jnp.diagonal(vals_b), dist

        eigs_b, dists = jax.vmap(one)(idx)            # (n_boot, k), (n_boot,)
        lo, hi = jnp.percentile(eigs_b, jnp.asarray([2.5, 97.5]), axis=0)
        return {
            "eigs": jnp.diagonal(vals0),
            "eig_lo": lo,
            "eig_hi": hi,
            "subspace_dist": dists,
        }

    def fit_svd(self, x_mat, n_iter: int | None = None,
                n_oversamples: int | None = None, key=0,
                mesh=None) -> FittedActiveSsRsvd:
        """RSVD path: RSVD of G / sqrt(N). Parity with
        active_subspaces.rs:233-250. ``mesh=`` as in ``fit``."""
        x = jnp.asarray(x_mat)
        if mesh is not None:
            x = self._shard_queries(x, mesh)
        k_features = x.shape[1]
        g = self.create_grad_mat(x) / jnp.sqrt(jnp.asarray(x.shape[0], x.dtype))
        u, s, _vt = random_svd(
            g,
            min(k_features, self.n_comps),
            n_iter if n_iter is not None else ASS_N_ITER,
            n_oversamples if n_oversamples is not None else ASS_N_OVERSAMPLES,
            key=as_key(key),
        )
        return FittedActiveSsRsvd(u, jnp.diag(s), self.n_comps)

"""POD with mode-weight interpolation (PodI).

Parity with reference pod_rom.rs:20-119: modes from RSVD of the snapshot
matrix with 10 power iterations / 10 oversamples (pod_rom.rs:56), optimal
per-snapshot weights via pinv(modes) (pod_rom.rs:61-75), linear-kernel RBF
interpolation of each mode weight over the exogenous variable t
(pod_rom.rs:78-95), prediction y(t) = modes @ w(t) (pod_rom.rs:107-118).

Deltas from the reference:
- the reference's per-snapshot weight loop is one batched matmul;
- the reference fits one RbfInterp per mode (pod_rom.rs:84-93) over the
  *same* support points — here all modes share a single saddle-system solve
  (the kernel matrix is identical across modes).

Snapshot layout matches the reference: rows = snapshots
(t.nrows() == x.nrows() asserted at pod_rom.rs:38).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from corrla_rs_tpu.ops.interp import rbf_fit, rbf_predict
from corrla_rs_tpu.ops.mat_utils import PRECISION, pinv
from corrla_rs_tpu.ops.random_svd import random_svd
from corrla_rs_tpu.utils.config import PodConfig
from corrla_rs_tpu.utils.prng import as_key

# Reference defaults (pod_rom.rs:56): 10 power iterations, 10 oversamples.
# Single source of truth: utils.config.
POD_N_ITER = PodConfig().n_iter
POD_N_OVERSAMPLES = PodConfig().n_oversamples


@functools.partial(jax.jit, static_argnames=("n_modes", "n_iter", "n_oversamples"))
def _pod_fit_kernel(x, t, n_modes, n_iter, n_oversamples, key):
    # modes = V^T of RSVD(snapshots), transposed -> (n_points, n_modes)
    _u, _s, vt = random_svd(x, n_modes, n_iter, n_oversamples, key=key)
    modes = vt.T
    # optimal weights per snapshot: one batched matmul instead of the
    # reference's per-row loop (pod_rom.rs:66-73)
    modes_inv = pinv(modes)  # (n_modes, n_points)
    weights = jnp.matmul(x, modes_inv.T, precision=PRECISION)  # (n_snap, n_modes)
    # linear-kernel, poly-degree-1 RBF over t for every mode at once
    coeffs = rbf_fit(t, weights, "linear", 1.0, 1)
    return modes, weights, coeffs


class PodI:
    """POD + interpolation ROM. Constructor mirrors PyPodI
    (lib_math_utils_py.rs:231-240): ``PodI(x_data, t, n_modes)``.

    Pass ``mesh=`` to fit with the spatial (n_points) axis sharded across
    chips: modes come from the sharded RSVD of the transposed snapshot
    matrix (points are the tall axis), and the weight solve exploits mode
    orthonormality (pinv(modes) == modes^T for orthonormal columns) so it
    is one psum-reduced matmul.
    """

    def __init__(self, x_data, t, n_modes: int, key=0, mesh=None,
                 config: PodConfig | None = None):
        cfg = config or PodConfig()
        self._n_iter = int(cfg.n_iter)
        self._n_oversamples = int(cfg.n_oversamples)
        self._mesh = mesh
        self.fit(x_data, t, n_modes, key=key)

    def fit(self, x_data, t, n_modes: int, key=0):
        """(Re)fit, parity with pod_rom.rs:98-101."""
        if self._mesh is None:
            from corrla_rs_tpu.utils.smallpath import maybe_route_small

            x_data, t = maybe_route_small(x_data, t)
        x = jnp.asarray(x_data)
        t = jnp.asarray(t)
        assert t.shape[0] == x.shape[0], "t rows must match snapshot rows"
        self.n_snapshots = x.shape[0]
        self.n_modes = int(n_modes)
        self.t_abscissa = t
        if self._mesh is not None:
            from corrla_rs_tpu.parallel.sharded_rsvd import sharded_random_svd

            # modes = left singular vectors of x^T (n_points tall, sharded)
            modes, _s, _vt = sharded_random_svd(
                x.T, self.n_modes, self._n_iter, self._n_oversamples,
                key=as_key(key), mesh=self._mesh,
            )
            self.modes = modes  # (n_points, n_modes) row-sharded
            # orthonormal modes: optimal weights = x @ modes (GSPMD inserts
            # the psum over the sharded points axis)
            weights = jnp.matmul(x, modes, precision=PRECISION)
            self.mode_weights = weights
            self._rbf_coeffs = rbf_fit(t, weights, "linear", 1.0, 1)
            return self
        self.modes, self.mode_weights, self._rbf_coeffs = _pod_fit_kernel(
            x, t, self.n_modes, self._n_iter, self._n_oversamples, as_key(key)
        )
        return self

    def predict(self, t_query) -> jnp.ndarray:
        """y(t) = sum_i w_i(t) phi_i. Parity with pod_rom.rs:107-118.

        Accepts (n_query, t_dim); returns (n_points, n_query) — for a single
        query row this matches the reference's (n_points, 1) output. A 1-D
        input is treated as one query point of dimension len(t_query).
        """
        tq = jnp.atleast_2d(jnp.asarray(t_query))
        w = rbf_predict(self.t_abscissa, self._rbf_coeffs, tq, "linear", 1.0, 1)
        return jnp.matmul(self.modes, w.T, precision=PRECISION)

"""Multi-chip truncated HOSVD: snapshot tensor sharded along its long axis.

Mesh coverage for ops/hosvd: the tensor
(I_0, I_1, ..., I_{d-1}) is sharded along axis 0 (the long snapshot/space
axis — the same "shard the tall dimension" story as
``parallel.sharded_rsvd``, SURVEY.md §2.2) and

- the mode-0 factor comes from ``sharded_random_svd`` of the mode-0
  unfolding, which is row-sharded for free (axis-0 rows stay local under
  ``reshape(I_0, -1)``);
- every short-mode factor comes from the leading eigenvectors of that
  mode's Gram matrix ``X_(k) X_(k)^T`` — accumulated as one local Gram
  per shard + a psum over the interconnect, then a replicated (I_k, I_k) ``eigh``
  (equivalent subspace to the unfolding-SVD factor the single-device
  path computes, exact rather than randomized);
- the core is the psum of each shard's contribution
  ``U_0[local]^T @ (slab x_1 U_1^T x_2 ...)``.

Communication: d-1 Gram psums of (I_k, I_k) + one (r_0, prod r) core
psum — tiny next to the sharded mode-0 RSVD.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from corrla_rs_tpu.ops.hosvd import _check_ranks, mode_multiply
from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.parallel.mesh import make_mesh
from corrla_rs_tpu.parallel.sharded_rsvd import sharded_random_svd

__all__ = ["sharded_hosvd"]


@functools.partial(
    jax.jit, static_argnames=("ranks", "mesh", "axis_name")
)
def _short_factors_and_core(tensor, u0, ranks, mesh, axis_name):
    ndim = tensor.ndim
    shape = tensor.shape

    def kernel(t_l, u0_l):
        # short-mode factors from psum'd Grams (replicated eigh — the
        # matrices are (I_k, I_k), trivial next to the sharded work)
        factors = []
        for k in range(1, ndim):
            unf = jnp.moveaxis(t_l, k, 0).reshape(shape[k], -1)
            g = lax.psum(
                jnp.matmul(unf, unf.T, precision=PRECISION), axis_name
            )
            _w, v = jnp.linalg.eigh(g)
            factors.append(v[:, ::-1][:, : ranks[k]])
        # core: project the local slab on every short mode, then fold the
        # local U_0 rows in; psum combines the shards
        proj = t_l
        for k in range(1, ndim):
            proj = mode_multiply(proj, factors[k - 1].T, k)
        pf = proj.reshape(proj.shape[0], -1)
        core_flat = lax.psum(
            jnp.matmul(u0_l.T, pf, precision=PRECISION), axis_name
        )
        return core_flat, tuple(factors)

    in_spec_t = P(*([axis_name] + [None] * (ndim - 1)))
    core_flat, factors = jax.shard_map(
        kernel,
        mesh=mesh,
        in_specs=(in_spec_t, P(axis_name, None)),
        out_specs=(P(), tuple(P() for _ in range(ndim - 1))),
    )(tensor, u0)
    core = core_flat.reshape(ranks)
    return core, factors


def sharded_hosvd(tensor, ranks, n_iter: int = 8, n_oversamples: int = 8,
                  key=0, mesh=None, axis_name: str | None = None):
    """Truncated HOSVD of an axis-0-sharded tensor over a device mesh.

    Returns ``(core, factors)`` like ``ops.hosvd.hosvd``; ``factors[0]``
    is row-sharded (I_0, r_0), the rest are replicated. Axis 0 must
    divide the mesh axis size. Same-answer parity with the single-device
    path is asserted in tests/test_parallel.py (reconstruction-level: the
    short-mode factors here are exact eigenvectors where the in-memory
    path uses randomized SVD, so individual factor columns may differ by
    sign/rotation within equal singular values).
    """
    mesh = mesh or make_mesh()
    axis_name = axis_name or mesh.axis_names[0]
    tensor = jnp.asarray(tensor)
    ranks = _check_ranks(ranks, tensor)
    n_dev = mesh.shape[axis_name]
    if tensor.shape[0] % n_dev != 0:
        raise ValueError(
            f"axis-0 length ({tensor.shape[0]}) must divide the mesh axis "
            f"size ({n_dev})"
        )
    ndim = tensor.ndim
    spec = P(*([axis_name] + [None] * (ndim - 1)))
    tensor = jax.device_put(tensor, NamedSharding(mesh, spec))

    # mode-0 factor: row-sharded randomized SVD of the tall unfolding
    n_rest = int(np.prod(tensor.shape[1:]))
    if ranks[0] > n_rest:
        raise ValueError(
            f"ranks[0]={ranks[0]} exceeds prod(other dims)={n_rest}; the "
            "mode-0 unfolding cannot have higher rank — lower ranks[0] "
            "(sharded_random_svd would silently clamp the sketch and the "
            "core reshape would fail late otherwise)"
        )
    if tensor.shape[0] < n_rest:
        raise ValueError(
            f"sharded_hosvd shards axis 0 and needs it to be the long "
            f"axis: I_0 = {tensor.shape[0]} < prod(other dims) = "
            f"{n_rest}; transpose the long mode to axis 0 (or use the "
            "single-device ops.hosvd.hosvd)"
        )
    unf0 = tensor.reshape(tensor.shape[0], n_rest)
    u0, _s, _vt = sharded_random_svd(
        unf0, ranks[0], n_iter, n_oversamples, key=key, mesh=mesh,
        axis_name=axis_name,
    )
    core, factors = _short_factors_and_core(
        tensor, u0, ranks, mesh, axis_name
    )
    return core, [u0] + list(factors)

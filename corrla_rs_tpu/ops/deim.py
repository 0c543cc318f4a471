"""DEIM: Discrete Empirical Interpolation Method (extension).

The classic companion to POD that the reference never had: given r POD
modes U (n, r), DEIM greedily selects r interpolation rows ("sensor
locations") such that any field in span(U) is reconstructed EXACTLY from
its values at those r points, and fields near the span are reconstructed
with error bounded by ||(P^T U)^{-1}|| times the projection error
(Chaturantabut & Sorensen 2010). Uses: sparse sensing, nonlinear-ROM
hyper-reduction, optimal sensor placement for the PodI/DMDc models.

Accelerator shape: the greedy loop is a ``lax.fori_loop`` whose step-j
solve runs on a PADDED r x r system (rows beyond j masked to identity —
static shapes, one small solve per step), so the whole selection jits;
reconstruction is two small matmuls.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from corrla_rs_tpu.ops.mat_utils import PRECISION

__all__ = ["deim_points", "deim_reconstruct"]


@jax.jit
def deim_points(modes: jnp.ndarray):
    """Greedy DEIM row selection for a mode matrix ``modes`` (n, r).

    Returns ``(points (r,) int32, proj (r, r))`` where ``points`` are the
    selected row indices (in greedy order) and
    ``proj = inv(modes[points, :])`` — the reconstruction operator's core
    (see ``deim_reconstruct``).
    """
    n, r = modes.shape
    dtype = modes.dtype

    p0 = jnp.argmax(jnp.abs(modes[:, 0])).astype(jnp.int32)
    points0 = jnp.zeros((r,), jnp.int32).at[0].set(p0)

    def body(j, points):
        # solve modes[points[:j], :j] c = modes[points[:j], j] on a padded
        # r x r system: rows >= j of the matrix become identity rows and
        # the rhs entries there are zeroed, so the padded solution equals
        # [c; 0]
        sel = modes[points]                     # (r, r) rows by current pts
        mask_row = jnp.arange(r) < j
        mask_col = jnp.arange(r) < j
        m = jnp.where(
            mask_row[:, None] & mask_col[None, :], sel, 0.0
        ) + jnp.where(
            ~mask_row, jnp.eye(r, dtype=dtype), 0.0
        )
        rhs = jnp.where(mask_row, sel[:, j], 0.0)
        c = jnp.linalg.solve(m, rhs)
        resid = modes[:, j] - jnp.matmul(
            modes, jnp.where(mask_col, c, 0.0), precision=PRECISION
        )
        pj = jnp.argmax(jnp.abs(resid)).astype(jnp.int32)
        return points.at[j].set(pj)

    points = lax.fori_loop(1, r, body, points0)
    proj = jnp.linalg.inv(modes[points])
    return points, proj


@functools.partial(jax.jit, static_argnames=())
def deim_reconstruct(modes: jnp.ndarray, proj: jnp.ndarray,
                     samples: jnp.ndarray) -> jnp.ndarray:
    """Reconstruct full fields from their values at the DEIM points.

    modes (n, r), proj (r, r) from ``deim_points``, samples (r,) or
    (r, m) — the field values AT the selected points (columns are
    separate fields). Returns (n,) or (n, m):
    ``x_hat = modes @ inv(modes[points, :]) @ samples`` — exact for any
    field in span(modes).
    """
    coeff = jnp.matmul(proj, samples, precision=PRECISION)
    return jnp.matmul(modes, coeff, precision=PRECISION)

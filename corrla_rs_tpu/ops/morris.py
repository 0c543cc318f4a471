"""Morris elementary-effects screening (extension).

The cheap precursor to Sobol' indices (ops/sobol): r trajectories of
d + 1 model evaluations give per-input sensitivity measures

    mu_star_i = mean |EE_i|   (overall importance; Campolongo 2007)
    sigma_i   = std EE_i      (nonlinearity / interaction strength)

with EE_i = (f(x + delta e_i) - f(x)) / delta along each trajectory —
r * (d + 1) evaluations total vs (d + 2) * n for Sobol', so it screens
high-dimensional models first (drop the inputs with tiny mu_star, spend
the Sobol' budget on the rest). The reference has no analogue (its only
global-sensitivity tool is the active-subspace measure).

Accelerator shape: trajectory construction is pure ``jax.random`` algebra
(radial steps via a permuted identity), all r * (d + 1) points evaluate
in ONE batched model call, and the elementary effects are a reshape +
diff — no Python loops anywhere.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.design import _box
from corrla_rs_tpu.utils.prng import as_key

__all__ = ["morris_trajectories", "morris_screening"]


def morris_trajectories(bounds, n_traj: int, key=0, n_levels: int = 4):
    """Morris (1991) one-at-a-time trajectories on a p-level grid.

    Returns ``(points (r, d+1, d), signs (r, d), order (r, d))``: each
    trajectory starts at a random grid point and flips one coordinate by
    ``+-delta`` per step (delta = p / (2(p-1)), the standard choice), in a
    random coordinate order; starts are chosen so every step stays inside
    the box. ``signs[t, j]`` is the direction coordinate ``order[t, j]``
    moved at step j of trajectory t.
    """
    d, lo, span = _box(bounds)
    p = int(n_levels)
    if p < 2 or p % 2:
        raise ValueError(f"n_levels must be even and >= 2, got {n_levels}")
    delta = p / (2.0 * (p - 1.0))

    k_start, k_perm, k_sign = jax.random.split(as_key(key), 3)
    # start levels in {0, 1/(p-1), ..., (p/2 - 1)/(p-1)} (so +delta stays
    # in [0, 1]); a negative step instead starts reflected at 1 - level
    levels = jax.random.randint(k_start, (n_traj, d), 0, p // 2) / (p - 1.0)
    signs = jnp.where(
        jax.random.bernoulli(k_sign, 0.5, (n_traj, d)), 1.0, -1.0
    )
    start = jnp.where(signs > 0, levels, 1.0 - levels)

    order = jax.vmap(
        lambda k: jax.random.permutation(k, d)
    )(jax.random.split(k_perm, n_traj))                     # (r, d)

    # step matrix: row j flips coordinate order[j] in ITS stored direction
    # (signs is indexed by coordinate; gather it into step order so the
    # start-point reflection and the actual step always agree)
    eye = jnp.eye(d)
    step_signs = jnp.take_along_axis(signs, order, axis=1)  # (r, d)
    steps = eye[order] * (step_signs[:, :, None] * delta)   # (r, d, d)
    offsets = jnp.concatenate(
        [jnp.zeros((n_traj, 1, d)), jnp.cumsum(steps, axis=1)], axis=1
    )                                                       # (r, d+1, d)
    unit = start[:, None, :] + offsets
    return lo + unit * span, signs, order


def morris_screening(f, bounds, n_traj: int = 64, key=0, n_levels: int = 4):
    """Elementary-effects screening of ``f`` over a box.

    f: vectorized model, (n, d) -> (n,). Evaluated once on the stacked
    (r * (d+1), d) design. Returns dict with ``mu`` (mean EE, signed),
    ``mu_star`` (mean |EE| — the importance ranking), ``sigma`` (std EE —
    nonlinearity/interactions), each (d,), plus ``ee`` (r, d) raw effects.
    """
    if n_traj < 2:
        raise ValueError(
            f"n_traj must be >= 2 (sigma uses ddof=1), got {n_traj}"
        )
    d, _lo, span = _box(bounds)
    pts, signs, order = morris_trajectories(
        bounds, n_traj, key=key, n_levels=n_levels
    )
    p = int(n_levels)
    delta = p / (2.0 * (p - 1.0))

    y = jnp.asarray(f(pts.reshape(n_traj * (d + 1), d))).reshape(
        n_traj, d + 1
    )
    # EE along step j belongs to coordinate order[t, j]; normalize by the
    # step in PHYSICAL units so mu_star is comparable across inputs with
    # different ranges (df/dx_i scale)
    step_signs = jnp.take_along_axis(signs, order, axis=1)
    diffs = (y[:, 1:] - y[:, :-1]) / (step_signs * delta * span[order])
    ee = jnp.zeros((n_traj, d)).at[
        jnp.arange(n_traj)[:, None], order
    ].set(diffs)
    mu = jnp.mean(ee, axis=0)
    mu_star = jnp.mean(jnp.abs(ee), axis=0)
    sigma = jnp.std(ee, axis=0, ddof=1)
    return {"mu": mu, "mu_star": mu_star, "sigma": sigma, "ee": ee}

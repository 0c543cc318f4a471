"""Explicit PRNG-key plumbing.

The reference uses unseedable ``rand::thread_rng()`` everywhere (e.g.
reference mat_utils.rs:171, space_samplers.rs:31). The rebuild threads
explicit ``jax.random`` keys through every stochastic API; a plain int seed
is accepted anywhere a key is, for convenience at the Python surface.
"""
from __future__ import annotations

import jax


def as_key(seed_or_key) -> jax.Array:
    """Coerce an int seed (concrete or traced) or a PRNG key to a PRNG key."""
    if seed_or_key is None:
        return jax.random.key(0)
    if isinstance(seed_or_key, int):
        return jax.random.key(seed_or_key)
    dtype = getattr(seed_or_key, "dtype", None)
    if dtype is not None and jax.dtypes.issubdtype(dtype, jax.dtypes.prng_key):
        return seed_or_key  # already a typed key
    if dtype is not None and jax.numpy.issubdtype(dtype, jax.numpy.integer):
        if getattr(seed_or_key, "ndim", 0) == 0:
            return jax.random.key(seed_or_key)  # traced/array scalar seed
        return seed_or_key  # legacy raw uint32 key data
    return seed_or_key


def split_key(seed_or_key, n: int = 2):
    """Split a seed-or-key into ``n`` fresh keys."""
    return jax.random.split(as_key(seed_or_key), n)

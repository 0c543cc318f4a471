"""Stochastic trace estimation: Hutchinson and Hutch++ — EXTENSION
(no reference analogue).

tr(A) for matrices only available through products (kernel Grams,
covariance products, Hessians of the library's surrogates) or too
large to form densely. Hutchinson (1989) averages x^T A x over
Rademacher probes: error ~ ||A||_F / sqrt(k). Hutch++ (Meyer, Musco,
Musco & Woodruff 2021) first captures A's dominant range with a
randomized QB step and applies Hutchinson only to the (small) residual
— error ~ tr(A)/k on PSD matrices, a quadratic improvement that makes
tiny probe budgets useful.

Accelerator shape: probes are drawn as ONE (n, k) Rademacher block, every
step is a dense (n, n) x (n, k) dense matmul, one jit end-to-end. Both
estimators also accept a matvec CALLABLE for matrix-free operators
(then the batched probe block goes through a single call: supply a
function that maps (n, k) -> (n, k)).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.utils.prng import as_key, split_key

__all__ = ["hutchinson_trace", "hutchpp_trace"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


def _apply(a, block):
    """A @ block for an explicit matrix or a batched-matvec callable."""
    if callable(a):
        return jnp.asarray(a(block))
    return _mm(jnp.asarray(a), block)


def _rademacher(key, shape, dtype):
    return jax.random.rademacher(key, shape, dtype=dtype)


def hutchinson_trace(a, n_probes: int = 64, key=0) -> float:
    """Plain Hutchinson estimate of tr(A): mean of x^T A x over
    Rademacher probes (error ~ ||A||_F / sqrt(n_probes)). ``a`` must
    be an explicit (n, n) matrix; for matrix-free operators use
    :func:`hutchpp_trace` with a callable and ``n_dim=``."""
    if n_probes < 1:
        raise ValueError(f"n_probes must be >= 1, got {n_probes}")
    if callable(a):
        raise TypeError(
            "hutchinson_trace needs an explicit matrix; use "
            "hutchpp_trace(a, n_dim=...) for callables"
        )
    a = jnp.asarray(a)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"a must be square, got {np.shape(a)}")
    x = _rademacher(as_key(key), (int(a.shape[0]), int(n_probes)),
                    a.dtype)
    return float(jnp.sum(x * _mm(a, x)) / n_probes)


def hutchpp_trace(a, n_probes: int = 64, key=0,
                  n_dim: int | None = None, dtype=None) -> float:
    """Hutch++ estimate of tr(A) with a total budget of ``n_probes``
    operator-block applications' worth of probes (split 1/3 sketch,
    1/3 range refinement via QR, 1/3 residual Hutchinson, as in the
    paper). ``a``: (n, n) matrix or batched matvec callable
    (n, k) -> (n, k) — callables must pass ``n_dim`` (and the probe
    dtype via ``dtype``). PSD error ~ tr(A) / n_probes."""
    if n_probes < 3:
        raise ValueError(f"n_probes must be >= 3, got {n_probes}")
    if callable(a):
        if n_dim is None:
            raise ValueError("callable operators need n_dim=")
        n = int(n_dim)
        # Respect the session's x64 config instead of assuming f64:
        # under default f32 jax, a hard jnp.float64 default would
        # silently downgrade with a warning.
        dt = dtype if dtype is not None else jnp.result_type(float)
    else:
        a = jnp.asarray(a)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"a must be square, got {np.shape(a)}")
        n = int(a.shape[0])
        dt = a.dtype if dtype is None else dtype
    k = max(int(n_probes) // 3, 1)
    k_sketch, k_resid = split_key(key)
    s = _rademacher(k_sketch, (n, k), dt)
    q, _ = jnp.linalg.qr(_apply(a, s))          # (n, k) range basis
    # exact trace on the captured range: tr(Q^T A Q)
    aq = _apply(a, q)
    t_range = jnp.sum(q * aq)
    # Hutchinson on the residual (I - QQ^T) A (I - QQ^T)
    g = _rademacher(k_resid, (n, k), dt)
    g = g - _mm(q, _mm(q.T, g))
    ag = _apply(a, g)
    ag = ag - _mm(q, _mm(q.T, ag))
    t_resid = jnp.sum(g * ag) / k
    return float(t_range + t_resid)

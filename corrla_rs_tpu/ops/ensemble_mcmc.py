"""Affine-invariant ensemble MCMC (Goodman-Weare stretch move) — EXTENSION.

The reference's only MCMC is plain DEMC (space_samplers.rs:252-418); its
efficiency collapses on strongly anisotropic / correlated targets unless
gamma is hand-tuned. The stretch move (Goodman & Weare 2010, the `emcee`
algorithm of Foreman-Mackey et al. 2013) is AFFINE-INVARIANT: its
performance is identical under any linear reparameterization x -> Ax + b,
so badly scaled targets cost nothing and the single tuning constant
``a`` (default 2.0) almost never needs changing.

One generation uses the parallel red-black split (emcee's "parallel
stretch move"): the first half of the ensemble updates using partners
drawn from the frozen second half, then vice versa — preserving detailed
balance while letting each half advance as ONE vmapped batch.

Accelerator shape (same design as ops/dream.py): per-generation randomness
is pre-drawn in batched chunks (the per-op dispatch overhead of this
runtime dominates small ensembles otherwise), both half-updates are
vmapped log-prob evaluations, and the generation loop is a ``lax.scan``.

z-draw: inverse-CDF of g(z) ∝ 1/sqrt(z) on [1/a, a]:
    z = ((a - 1) u + 1)^2 / a,  u ~ U(0, 1).
Acceptance: ln q = (d - 1) ln z + lnp(y) - lnp(x).
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from corrla_rs_tpu.utils.prng import as_key

__all__ = ["EnsembleState", "stretch_run", "EnsembleSampler"]


class EnsembleState(NamedTuple):
    walkers: jnp.ndarray     # (n_walkers, ndim)
    lnp: jnp.ndarray         # (n_walkers,)
    key: jnp.ndarray
    n_accept: jnp.ndarray    # scalar int32
    n_reject: jnp.ndarray    # scalar int32


class _GenRand(NamedTuple):
    """Pre-drawn randomness for one generation (two half-updates)."""
    partners: jnp.ndarray    # (2, half) int in [0, half)
    u_z: jnp.ndarray         # (2, half) uniform for the z inverse-CDF
    u_acc: jnp.ndarray       # (2, half) uniform for metropolis accept


def _half_update(walkers, lnps, other, rand_p, rand_z,
                 rand_acc, ln_prob_fn, a):
    """Stretch-update one half against the (frozen) other half."""
    half, ndim = walkers.shape
    dtype = walkers.dtype
    z = ((a - 1.0) * rand_z + 1.0) ** 2 / a                  # (half,)
    partners = other[rand_p]                                  # (half, ndim)
    prop = partners + z[:, None] * (walkers - partners)
    lnp_prop = jax.vmap(ln_prob_fn)(prop)
    ln_q = (ndim - 1.0) * jnp.log(z) + lnp_prop - lnps
    alpha = jnp.exp(jnp.minimum(ln_q, 0.0))
    alpha = jnp.where(jnp.isnan(alpha), 0.0, alpha)
    accepts = rand_acc < alpha
    new_w = jnp.where(accepts[:, None], prop, walkers)
    new_lnp = jnp.where(accepts, lnp_prop, lnps)
    return new_w, new_lnp, jnp.sum(accepts, dtype=jnp.int32)


def _stretch_gen(state: EnsembleState, rand: _GenRand, ln_prob_fn,
                 a: float) -> EnsembleState:
    """One full generation: update first half vs second, then second vs
    the FRESH first half (emcee Algorithm 3)."""
    n = state.walkers.shape[0]
    half = n // 2
    w0, w1 = state.walkers[:half], state.walkers[half:]
    l0, l1 = state.lnp[:half], state.lnp[half:]
    w0, l0, acc0 = _half_update(
        w0, l0, w1, rand.partners[0], rand.u_z[0], rand.u_acc[0],
        ln_prob_fn, a)
    w1, l1, acc1 = _half_update(
        w1, l1, w0, rand.partners[1], rand.u_z[1], rand.u_acc[1],
        ln_prob_fn, a)
    n_acc = state.n_accept + acc0 + acc1
    n_rej = state.n_reject + (n - acc0 - acc1)
    return EnsembleState(
        jnp.concatenate([w0, w1]), jnp.concatenate([l0, l1]),
        state.key, n_acc, n_rej)


def _draw_chunk(key, n_gens, half, dtype):
    ks = jax.random.split(key, 3)
    return _GenRand(
        partners=jax.random.randint(ks[0], (n_gens, 2, half), 0, half),
        u_z=jax.random.uniform(ks[1], (n_gens, 2, half), dtype),
        u_acc=jax.random.uniform(ks[2], (n_gens, 2, half), dtype),
    )


@functools.partial(
    jax.jit, static_argnames=("ln_prob_fn", "n_chunks", "chunk", "unroll"))
def _stretch_scan(state, ln_prob_fn, n_chunks, chunk, a, unroll):
    half = state.walkers.shape[0] // 2
    dtype = state.walkers.dtype

    def inner(st, rand):
        st = _stretch_gen(st, rand, ln_prob_fn, a)
        return st, st.walkers

    def outer(state, _):
        key, k_draw = jax.random.split(state.key)
        rand = _draw_chunk(k_draw, chunk, half, dtype)
        state, hist = lax.scan(
            inner, state._replace(key=key), rand,
            unroll=min(unroll, max(chunk, 1)),
        )
        return state, hist

    state, hist = lax.scan(outer, state, None, length=n_chunks)
    n, ndim = state.walkers.shape
    return state, hist.reshape(n_chunks * chunk, n, ndim)


def stretch_run(init_walkers, ln_prob_fn: Callable, n_steps: int,
                a: float = 2.0, key=0, unroll: int = 4):
    """Run ``n_steps`` stretch-move generations.

    init_walkers (n_walkers, ndim): n_walkers must be even and should be
    >= 2*ndim (emcee guidance) with nondegenerate spread — the ensemble
    can only propose within the affine hull of its walkers.

    Returns (history (n_steps, n_walkers, ndim), final EnsembleState).
    Resumable: pass ``state.walkers``/``state.key`` back in.
    """
    from corrla_rs_tpu.ops.dream import _chunk_for

    heads = jnp.asarray(init_walkers)
    n = heads.shape[0]
    if n < 4 or n % 2:
        raise ValueError(f"need an even n_walkers >= 4, got {n}")
    lnp0 = jax.vmap(ln_prob_fn)(heads)
    state = EnsembleState(
        heads, lnp0, as_key(key),
        jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
    )
    n_steps = int(n_steps)
    run = functools.partial(_stretch_scan, ln_prob_fn=ln_prob_fn,
                            a=float(a), unroll=unroll)
    histories = []
    chunk_size = _chunk_for(n)
    n_main, rem = divmod(n_steps, chunk_size)
    if n_main:
        state, h = run(state, n_chunks=n_main, chunk=chunk_size)
        histories.append(h)
    if rem:
        state, h = run(state, n_chunks=1, chunk=rem)
        histories.append(h)
    if not histories:  # n_steps == 0: empty history, state unchanged
        return (jnp.zeros((0,) + state.walkers.shape, state.walkers.dtype),
                state)
    history = (histories[0] if len(histories) == 1
               else jnp.concatenate(histories, axis=0))
    return history, state


class EnsembleSampler:
    """Stateful wrapper mirroring the DeMcSampler surface
    (ops/samplers.py): ``sample_mcmc`` appends to an in-memory history,
    ``get_samples(n_tail)`` reads it out walker-interleaved (the
    reference's chain-round-robin ordering, space_samplers.rs:309-323).
    """

    def __init__(self, ln_prob_fn: Callable, init_walkers, a: float = 2.0,
                 key=0):
        self.ln_prob_fn = ln_prob_fn
        self.a = float(a)
        self._init = jnp.asarray(init_walkers)
        self._key = as_key(key)
        self._history = None
        self._state = None
        self._prev_acc = 0
        self._prev_rej = 0

    def sample_mcmc(self, n_samples: int):
        """Advance by ceil(n_samples / n_walkers) generations."""
        n_w = self._init.shape[0]
        n_gens = -(-int(n_samples) // n_w)
        start = (self._state.walkers if self._state is not None
                 else self._init)
        key = self._state.key if self._state is not None else self._key
        hist, state = stretch_run(start, self.ln_prob_fn, n_gens,
                                  a=self.a, key=key)
        # counters restart at 0 per stretch_run; accumulate across calls
        state = state._replace(
            n_accept=state.n_accept + self._prev_acc,
            n_reject=state.n_reject + self._prev_rej,
        )
        self._prev_acc = int(state.n_accept)
        self._prev_rej = int(state.n_reject)
        self._history = (hist if self._history is None
                         else jnp.concatenate([self._history, hist]))
        self._state = state
        return self

    def accept_ratio(self) -> float:
        if self._state is None:
            return 0.0
        acc = float(self._state.n_accept)
        tot = acc + float(self._state.n_reject)
        return acc / max(tot, 1.0)

    @property
    def chain_history(self) -> jnp.ndarray:
        return self._history

    def get_samples(self, n_tail: int) -> jnp.ndarray:
        """Last n_tail generations, walker-interleaved:
        (n_tail * n_walkers, ndim)."""
        h = self._history[-int(n_tail):]
        t, n, d = h.shape
        return h.reshape(t * n, d)

"""Constrained-space samplers: Dirichlet rejection + DEMC MCMC.

Parity with reference space_samplers.rs:

- ``constr_dirichlet_sample`` (space_samplers.rs:64-126): draw x with
  sum_i x_i = c_scale and lb_i <= x_i <= ub_i by rejection. The reference
  loops shots of ``chunk_size`` Dirichlet deviates on Rayon threads
  (space_samplers.rs:98-118); here one ``lax.while_loop`` draws whole chunks
  with ``jax.random.dirichlet`` on-device and scatters accepted rows into a
  fixed-shape output buffer (masked fill — the jit-safe formulation of
  "collect until n valid").
- ``DeMcSampler`` (space_samplers.rs:252-418): differential-evolution MCMC.
  Proposal x' = x + gamma (x_a - x_b) + U(0, eps) from two random *other*
  chains (space_samplers.rs:326-347), optional proposal fixup, Metropolis
  accept (space_samplers.rs:400-417). Rebuild: all chains advance as one
  vmapped pure function of (state, key); the time loop is ``lax.scan``;
  ``get_samples`` interleaves chains round-robin exactly like
  space_samplers.rs:309-323 (observable API ordering).

Log-probability combinators mirror space_samplers.rs:154-250 as plain
composable Python callables (sample (d,) -> scalar lnp, traced under jit).
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax
from jax.scipy.special import gammaln

from corrla_rs_tpu.utils.config import DemcConfig, DirichletSamplerConfig
from corrla_rs_tpu.utils.prng import as_key

# Library-wide defaults (utils.config is the single source of truth).
_DEMC_CFG = DemcConfig()
_DIRICHLET_CFG = DirichletSamplerConfig()

__all__ = [
    "constr_dirichlet_sample",
    "ln_prior_uniform",
    "ln_like_dirichlet",
    "ln_like_sum",
    "DeMcSampler",
    "demc_run",
    "demc_run_serial",
    "demc_step",
]


def _broadcast_alphas(alphas, ndim: int):
    """Alpha validation/broadcast, parity with space_samplers.rs:76-95.

    Host numpy throughout: the result feeds a host-level uniformity check
    and a jit argument — building it as a device array costs a dispatch
    plus a device->host fetch per call.
    """
    if alphas is None:
        return np.ones((ndim,))
    a = np.atleast_1d(np.asarray(alphas, dtype=np.float64))
    if a.shape[0] == 1:
        return np.broadcast_to(a, (ndim,))
    if a.shape[0] != ndim:
        raise ValueError(
            "Number of shape parameters to Dirichlet sampler must be ndim "
            "or 1 for the sym case"
        )
    return a


@functools.partial(
    jax.jit,
    static_argnames=("n_samples", "max_zshots", "chunk_size", "uniform_simplex"),
)
def _rejection_fill(key, bounds, alphas, n_samples, max_zshots, chunk_size,
                    c_scale, uniform_simplex=False):
    ndim = bounds.shape[0]
    dtype = bounds.dtype
    out = jnp.zeros((n_samples, ndim), dtype)

    def cond(state):
        _key, count, shot, _out = state
        return (count < n_samples) & (shot < max_zshots)

    def body(state):
        key, count, shot, out = state
        key, sub = jax.random.split(key)
        if uniform_simplex:
            # Dirichlet(1,...,1) == normalized exponentials: jax's general
            # gamma sampler costs ~80s of compile and 2.6x the runtime for
            # this (very common) case
            e = jax.random.exponential(sub, (chunk_size, ndim), dtype)
            zs = e / jnp.sum(e, axis=1, keepdims=True)
        else:
            zs = jax.random.dirichlet(sub, alphas, (chunk_size,), dtype=dtype)
        zs = zs * c_scale
        ok = jnp.all(
            (bounds[:, 0][None, :] <= zs) & (zs <= bounds[:, 1][None, :]),
            axis=1,
        )
        # Compact accepted rows to the front with top_k over priority keys
        # (accepted rows keep their chunk order), then gather only
        # n_samples rows instead of scattering the whole chunk into `out`.
        prio = jnp.where(ok, jnp.arange(chunk_size, dtype=jnp.int32),
                         jnp.int32(chunk_size))
        k_sel = min(n_samples, chunk_size)
        _neg, sel = lax.top_k(-prio, k_sel)
        take = zs[sel]
        take_ok = ok[sel]
        dest = count + jnp.arange(k_sel, dtype=jnp.int32)
        dest = jnp.where(take_ok & (dest < n_samples), dest, n_samples)
        out = out.at[dest].set(take, mode="drop")
        count = jnp.minimum(count + jnp.sum(ok, dtype=jnp.int32), n_samples)
        return key, count, shot + jnp.int32(1), out

    _key, count, _shot, out = lax.while_loop(
        cond, body, (key, jnp.int32(0), jnp.int32(0), out)
    )
    return out, count


def constr_dirichlet_sample(bounds, n_samples: int,
                            max_zshots: int = _DIRICHLET_CFG.max_zshots,
                            chunk_size: int = _DIRICHLET_CFG.chunk_size,
                            c_scale: float = _DIRICHLET_CFG.c_scale,
                            alphas=None, key=0, backend: str = "device"):
    """Rejection-sample the bounded simplex sum(x) = c_scale.

    Parity with space_samplers.rs:64-126. Raises if ``max_zshots`` chunks
    were insufficient (the reference silently returns zero-rows; SURVEY.md
    §2.4 — we fail loudly instead).

    backend='host' routes to the multithreaded C++ streaming sampler
    (corrla_rs_tpu.native) — the right tool at pathological acceptance
    rates where the fixed-chunk device loop wastes bandwidth on rejected
    rows.
    """
    import numpy as _np

    if backend == "host":
        from corrla_rs_tpu import native as _native

        if isinstance(key, int):
            seed_int = key  # avoid a device op (key_data compiles remotely)
        else:
            seed_int = int(_np.asarray(jax.random.key_data(as_key(key)))[-1])
        return jnp.asarray(_native.cs_dirichlet_rejection_host(
            _np.asarray(bounds, _np.float64), int(n_samples),
            int(max_zshots), int(chunk_size), float(c_scale),
            _np.ones(_np.asarray(bounds).shape[0])
            if alphas is None else _np.asarray(alphas, _np.float64),
            seed=seed_int,
        ))

    from corrla_rs_tpu.utils.smallpath import maybe_route_small

    # per-shot work is chunk_size x ndim draws; below the dispatch-bound
    # crossover the whole while_loop runs faster on the CPU backend
    ndim_b = _np.shape(bounds)[0]
    (bounds,) = maybe_route_small(
        bounds, work_elems=int(chunk_size) * int(ndim_b)
    )
    bounds = jnp.asarray(bounds, dtype=jnp.result_type(float))
    alphas = _broadcast_alphas(alphas, bounds.shape[0])
    # detect the uniform-simplex case at the host level (alphas are
    # concrete here) and take the cheap exponential path
    uniform = bool(_np.all(_np.asarray(alphas) == 1.0))
    out, count = _rejection_fill(
        as_key(key), bounds, alphas, int(n_samples), int(max_zshots),
        int(chunk_size), float(c_scale), uniform_simplex=uniform,
    )
    if int(count) < n_samples:
        raise RuntimeError(
            f"constr_dirichlet_sample: only {int(count)}/{n_samples} valid "
            f"samples found within max_zshots={max_zshots} chunks of "
            f"{chunk_size}; loosen bounds or raise max_zshots/chunk_size"
        )
    return out


# ---------------------------------------------------------------------------
# Log-probability combinators (space_samplers.rs:154-250)
# ---------------------------------------------------------------------------

def ln_prior_uniform(bounds) -> Callable:
    """Flat prior on an open box: 0 inside, -inf outside.

    Parity with LnPriorUniform (space_samplers.rs:175-199, strict
    inequalities).
    """
    # host numpy constant: embeds at trace time with NO runtime device op
    # (a jnp constant here costs one accelerator dispatch per closure
    # construction, pure overhead for the CPU-routed small-sampler path)
    bounds = np.asarray(bounds, dtype=np.float64)

    def lnp(x):
        ok = jnp.all((bounds[:, 0] < x) & (x < bounds[:, 1]))
        return jnp.where(ok, 0.0, -jnp.inf)

    return lnp


def ln_like_dirichlet(alphas) -> Callable:
    """Dirichlet log-pdf. Parity with LnLikeDirichlet
    (space_samplers.rs:202-229), computed in log space (the reference goes
    through gamma() products, equivalent up to fp rounding)."""
    import scipy.special as _sps

    # host numpy constants (see ln_prior_uniform's rationale)
    a = np.atleast_1d(np.asarray(alphas, dtype=np.float64))
    ln_beta = float(np.sum(_sps.gammaln(a)) - _sps.gammaln(np.sum(a)))

    def lnp(x):
        return jnp.sum((a - 1.0) * jnp.log(x)) - ln_beta

    return lnp


def ln_like_sum(*fns: Callable) -> Callable:
    """Posterior numerator: sum of log terms. space_samplers.rs:232-250."""

    def lnp(x):
        total = 0.0
        for f in fns:
            total = total + f(x)
        return total

    return lnp


# ---------------------------------------------------------------------------
# DEMC
# ---------------------------------------------------------------------------

class DemcState(NamedTuple):
    heads: jnp.ndarray      # (n_chains, ndim)
    head_lnp: jnp.ndarray   # (n_chains,)
    key: jnp.ndarray
    n_accept: jnp.ndarray   # scalar int
    n_reject: jnp.ndarray   # scalar int


def _pick_two_others(key, c, n_chains):
    """Two distinct chain indices != c, O(1) double-draw (no permutation)."""
    k1, k2 = jax.random.split(key)
    a = jax.random.randint(k1, (), 0, n_chains - 1)
    a = a + (a >= c)
    b = jax.random.randint(k2, (), 0, n_chains - 2)
    lo = jnp.minimum(c, a)
    hi = jnp.maximum(c, a)
    b = b + (b >= lo)
    b = b + (b >= hi)
    return a, b


def pick_others_batched(key, n_chains: int, k: int,
                        n_batch: int | None = None) -> jnp.ndarray:
    """(n_chains, k) random indices, distinct per row and != the row index.

    O(k^2) work per chain (k is tiny) via sequential draws from shrinking
    ranges with sorted-exclusion shifting — the batched generalization of
    ``_pick_two_others``. This keeps one DEMC/DREAM generation O(n_chains)
    total (a per-chain ``jax.random.permutation`` would be O(n_chains^2)
    per step and measurably collapses throughput past ~2k chains).

    ``n_batch``: draw for n_batch independent generations at once —
    returns (n_batch, n_chains, k). Used by the chunked DREAM scan to
    amortize the per-generation draw/sort kernels.
    """
    shape = (n_chains,) if n_batch is None else (n_batch, n_chains)
    keys = jax.random.split(key, k)
    c = jnp.broadcast_to(jnp.arange(n_chains), shape)
    chosen = []
    for j in range(k):
        r = jax.random.randint(keys[j], shape, 0, n_chains - 1 - j)
        exc = jnp.sort(jnp.stack([c] + chosen, axis=-1), axis=-1)
        for m in range(j + 1):
            r = r + (r >= exc[..., m])
        chosen.append(r)
    return jnp.stack(chosen, axis=-1)


def _demc_step_pre(state: DemcState, rand, ln_prob_fn, gamma: float,
                   prop_fixup_fn=None) -> DemcState:
    """One DEMC generation from pre-drawn randomness.

    Proposal parity with space_samplers.rs:326-358; all chains propose from
    the same generation of heads, matching the reference's parallel
    ``sample_mcmc_par`` (space_samplers.rs:377-393).
    """
    n_chains, _ndim = state.heads.shape
    pairs, jitter, u_acc = rand
    delta = state.heads[pairs[:, 0]] - state.heads[pairs[:, 1]]
    prop = state.heads + gamma * delta + jitter
    if prop_fixup_fn is not None:
        prop = jax.vmap(prop_fixup_fn)(prop)
    lnp_prop = jax.vmap(ln_prob_fn)(prop)
    # alpha = clip(exp(lnp' - lnp), 0, 1) (space_samplers.rs:400-408)
    alpha = jnp.exp(jnp.minimum(lnp_prop - state.head_lnp, 0.0))
    alpha = jnp.where(jnp.isnan(alpha), 0.0, alpha)
    accepts = u_acc < alpha
    xs = jnp.where(accepts[:, None], prop, state.heads)
    lnps = jnp.where(accepts, lnp_prop, state.head_lnp)
    n_acc = state.n_accept + jnp.sum(accepts, dtype=jnp.int32)
    n_rej = state.n_reject + (n_chains - jnp.sum(accepts, dtype=jnp.int32))
    return DemcState(xs, lnps, state.key, n_acc, n_rej)


def demc_step(state: DemcState, ln_prob_fn, gamma: float, var_epsilon: float,
              prop_fixup_fn=None) -> DemcState:
    """Advance every chain one DEMC step (vmapped), drawing fresh
    randomness from ``state.key`` (see _demc_step_pre for the kernel)."""
    n_chains, ndim = state.heads.shape
    dtype = state.heads.dtype
    key, k_pick, k_jit, k_acc = jax.random.split(state.key, 4)
    rand = (
        pick_others_batched(k_pick, n_chains, 2),
        jax.random.uniform(k_jit, (n_chains, ndim), dtype, 0.0, var_epsilon),
        jax.random.uniform(k_acc, (n_chains,), dtype),
    )
    return _demc_step_pre(
        state._replace(key=key), rand, ln_prob_fn, gamma, prop_fixup_fn
    )


@functools.partial(
    jax.jit,
    static_argnames=("ln_prob_fn", "n_chunks", "chunk", "prop_fixup_fn",
                     "unroll"),
)
def _demc_scan(state, ln_prob_fn, n_chunks, chunk, gamma, var_epsilon,
               prop_fixup_fn, unroll):
    """n_chunks x chunk generations; randomness pre-drawn per chunk (the
    per-generation PRNG kernels dominate small populations on this
    runtime — same design as ops.dream._dream_scan)."""
    n_chains, ndim = state.heads.shape
    dtype = state.heads.dtype

    def inner(st, rand):
        st = _demc_step_pre(st, rand, ln_prob_fn, gamma, prop_fixup_fn)
        return st, st.heads

    def outer(state, _):
        key, k_pick, k_jit, k_acc = jax.random.split(state.key, 4)
        rand = (
            pick_others_batched(k_pick, n_chains, 2, n_batch=chunk),
            jax.random.uniform(
                k_jit, (chunk, n_chains, ndim), dtype, 0.0, var_epsilon
            ),
            jax.random.uniform(k_acc, (chunk, n_chains), dtype),
        )
        state, hist = lax.scan(
            inner, state._replace(key=key), rand,
            unroll=min(unroll, max(chunk, 1)),
        )
        return state, hist

    state, hist = lax.scan(outer, state, None, length=n_chunks)
    return state, hist.reshape(n_chunks * chunk, n_chains, ndim)


def demc_run(init_heads, ln_prob_fn, n_steps: int, gamma: float,
             var_epsilon: float, key, prop_fixup_fn=None, unroll: int = 4):
    """Run n_steps of DEMC on all chains; returns (history, state).

    history: (n_steps, n_chains, ndim) — one generation per step.
    """
    from corrla_rs_tpu.ops.dream import _chunk_for

    heads = jnp.asarray(init_heads)
    lnp0 = jax.vmap(ln_prob_fn)(heads)
    state = DemcState(
        heads, lnp0, as_key(key),
        jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
    )
    n_steps = int(n_steps)
    run = functools.partial(
        _demc_scan, ln_prob_fn=ln_prob_fn, gamma=gamma,
        var_epsilon=var_epsilon, prop_fixup_fn=prop_fixup_fn, unroll=unroll,
    )
    histories = []
    chunk_size = _chunk_for(heads.shape[0])
    n_main, rem = divmod(n_steps, chunk_size)
    if n_main:
        state, h = run(state, n_chunks=n_main, chunk=chunk_size)
        histories.append(h)
    if rem:
        state, h = run(state, n_chunks=1, chunk=rem)
        histories.append(h)
    if not histories:  # n_steps == 0: empty history, state unchanged
        return jnp.zeros((0,) + state.heads.shape, state.heads.dtype), state
    history = (
        histories[0] if len(histories) == 1
        else jnp.concatenate(histories, axis=0)
    )
    return history, state


@functools.partial(
    jax.jit,
    static_argnames=("ln_prob_fn", "n_steps", "prop_fixup_fn"),
)
def demc_run_serial(init_heads, ln_prob_fn, n_steps: int, gamma: float,
                    var_epsilon: float, key, prop_fixup_fn=None):
    """Serial-update DEMC: within a generation, chain c's proposal reads
    the heads of chains < c ALREADY UPDATED this generation — exact
    semantics of the reference's serial ``sample_mcmc``
    (space_samplers.rs:361-374), as opposed to the generation-synchronous
    ``demc_run`` (= the reference's ``sample_mcmc_par``). Both are valid
    DEMC; this mode exists for declared-behavior parity. The inner chain
    loop is inherently sequential (a lax.scan over chains), so throughput
    is O(n_chains) dispatches per generation — use ``demc_run`` for speed.
    """
    heads = jnp.asarray(init_heads)
    n_chains, ndim = heads.shape
    dtype = heads.dtype
    lnp0 = jax.vmap(ln_prob_fn)(heads)
    state = DemcState(
        heads, lnp0, as_key(key),
        jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
    )

    def chain_body(carry, inp):
        heads, lnps, n_acc = carry
        c, ck = inp
        k_pick, k_jit, k_acc = jax.random.split(ck, 3)
        a, b = _pick_two_others(k_pick, c, n_chains)
        delta = heads[a] - heads[b]
        jitter = jax.random.uniform(k_jit, (ndim,), dtype, 0.0, var_epsilon)
        prop = heads[c] + gamma * delta + jitter
        if prop_fixup_fn is not None:
            prop = prop_fixup_fn(prop)
        lnp_prop = ln_prob_fn(prop)
        alpha = jnp.exp(jnp.minimum(lnp_prop - lnps[c], 0.0))
        alpha = jnp.where(jnp.isnan(alpha), 0.0, alpha)
        accept = jax.random.uniform(k_acc, (), dtype) < alpha
        heads = heads.at[c].set(jnp.where(accept, prop, heads[c]))
        lnps = lnps.at[c].set(jnp.where(accept, lnp_prop, lnps[c]))
        return (heads, lnps, n_acc + accept.astype(jnp.int32)), None

    def gen_body(state, _):
        key, k_gen = jax.random.split(state.key)
        chain_keys = jax.random.split(k_gen, n_chains)
        (heads, lnps, n_acc), _ = lax.scan(
            chain_body,
            (state.heads, state.head_lnp, state.n_accept),
            (jnp.arange(n_chains), chain_keys),
        )
        n_rej = state.n_reject + (
            n_chains - (n_acc - state.n_accept)
        )
        new_state = DemcState(heads, lnps, key, n_acc, n_rej)
        return new_state, heads

    state, history = lax.scan(gen_body, state, None, length=n_steps)
    return history, state


class DeMcSampler:
    """Differential-evolution MCMC over parallel chains.

    Mirrors DeMcSampler (space_samplers.rs:252-418): >= 3 chains, gamma,
    var_epsilon, optional proposal fixup, acceptance bookkeeping, and the
    round-robin ``get_samples`` readout. ``ln_prob_fn`` maps a single (d,)
    sample to a scalar log-probability (jit-traceable).

    ``sample_mcmc(n, mode=...)``: mode="parallel" (default) advances all
    chains generation-synchronously (= the reference's ``sample_mcmc_par``,
    the vmapped path); mode="serial" reproduces the reference's
    serial ``sample_mcmc`` update order (chains see earlier chains' updates
    within the same generation, space_samplers.rs:361-374) — offered for
    declared-behavior parity, at sequential-loop speed.
    """

    def __init__(self, ln_prob_fn: Callable, init_chains,
                 gamma: float = _DEMC_CFG.gamma,
                 var_epsilon: float = _DEMC_CFG.var_epsilon,
                 prop_fixup_fn: Callable | None = None,
                 key=0, config: DemcConfig | None = None):
        from corrla_rs_tpu.utils.smallpath import route_sampler_small

        n_ch = np.shape(init_chains)[0]
        # with routing on (utils/smallpath), a small population runs the
        # whole scan on the in-process CPU backend
        (init_chains,) = route_sampler_small(init_chains, n_chains=n_ch)
        heads = jnp.asarray(init_chains)
        assert heads.ndim == 2 and heads.shape[0] >= 3, "need >= 3 chains"
        self.n_chains, self.ndim = heads.shape
        if config is not None:
            gamma, var_epsilon = config.gamma, config.var_epsilon
        self.gamma = float(gamma)
        self.var_epsilon = float(var_epsilon)
        self.ln_prob_fn = ln_prob_fn
        self.prop_fixup_fn = prop_fixup_fn
        self._key = as_key(key)
        self._heads = heads
        self._history = [heads[None, :, :]]  # list of (n_steps, n_chains, d)
        self.n_accept = 0
        self.n_reject = 0

    def sample_mcmc(self, n_samples: int, mode: str = "parallel"):
        """Draw n_samples generations on all chains (one fused scan).

        mode="serial" uses the reference's sequential within-generation
        update order (see class docstring)."""
        self._key, run_key = jax.random.split(self._key)
        runner = demc_run_serial if mode == "serial" else demc_run
        history, state = runner(
            self._heads, self.ln_prob_fn, int(n_samples), self.gamma,
            self.var_epsilon, run_key, self.prop_fixup_fn,
        )
        self._heads = state.heads
        self._history.append(history)
        self.n_accept += int(state.n_accept)
        self.n_reject += int(state.n_reject)
        return self

    def sample_mcmc_par(self, n_samples: int):
        """The reference's parallel variant — same math as the default
        ``sample_mcmc`` path (space_samplers.rs:377-393)."""
        return self.sample_mcmc(n_samples, mode="parallel")

    def accept_ratio(self) -> float:
        """Global acceptance ratio. space_samplers.rs:396-398."""
        total = self.n_accept + self.n_reject
        return self.n_accept / total if total else 0.0

    @property
    def chain_history(self) -> jnp.ndarray:
        """(n_generations, n_chains, ndim) including the seed generation."""
        return jnp.concatenate(self._history, axis=0)

    def get_chain_samples(self, n_tail: int, chain_id: int) -> jnp.ndarray:
        """Last n_tail samples of one chain. space_samplers.rs:300-305."""
        return self.chain_history[-n_tail:, chain_id, :]

    def get_samples(self, n_tail: int) -> jnp.ndarray:
        """Last n_tail generations, chains interleaved round-robin
        (generation-major, chain-minor), parity with
        space_samplers.rs:309-323.

        Note: n_tail=0 returns an empty array — matching the reference's
        *actual* behavior (its docstring claims "all samples" but the
        output buffer is sized n_tail*n_chains, space_samplers.rs:314)."""
        if n_tail == 0:
            return jnp.zeros((0, self.ndim), self.chain_history.dtype)
        tail = self.chain_history[-n_tail:]  # (n_tail, n_chains, d)
        return tail.reshape(n_tail * self.n_chains, self.ndim)

"""DREAM: DiffeRential Evolution Adaptive Metropolis.

The reference README advertises DREAM (readme.md:44) but only implements
plain DEMC (space_samplers.rs:252-418 has no adaptive crossover, no
multi-pair proposals, no gamma=1 mode jumps — SURVEY.md §2.4 item 4). This
module is the real thing, per Vrugt et al. 2009 ("Accelerating Markov chain
Monte Carlo simulation by differential evolution with self-adaptive
randomized subspace sampling"):

- multi-pair proposals: delta ~ U{1..delta_max} chain-pair differences
- subspace sampling: each dimension updated with probability CR
- adaptive crossover: nCR candidate CR values with selection probabilities
  adapted from normalized jump distances during burn-in
- gamma = 2.38 / sqrt(2 delta d') with unit-gamma mode jumps at probability
  p_gamma1 (default 0.2, i.e. every ~5th generation)
- (1+e) multiplicative and eps additive proposal noise

Accelerator design: all chains advance as one vmapped generation inside
``lax.scan`` — the ">= 1M samples/sec" north-star kernel.
Optional Vrugt-style outlier-chain correction (``outlier_reset`` /
DreamSampler(outlier_correct=True)) runs only inside the burn-in window;
adaptation freezes after ``n_adapt`` generations so the stationary chain
is a valid MCMC.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from corrla_rs_tpu.ops.samplers import pick_others_batched
from corrla_rs_tpu.utils.config import DreamConfig
from corrla_rs_tpu.utils.prng import as_key

__all__ = [
    "DreamState", "make_dream_state", "dream_run", "DreamSampler",
    "outlier_reset",
]

# Library-wide defaults (utils.config is the single source of truth).
_CFG = DreamConfig()


class DreamState(NamedTuple):
    heads: jnp.ndarray       # (n_chains, d)
    head_lnp: jnp.ndarray    # (n_chains,)
    key: jnp.ndarray
    p_cr: jnp.ndarray        # (n_cr,) crossover selection probabilities
    jump_dist: jnp.ndarray   # (n_cr,) accumulated normalized jump distance
    n_id: jnp.ndarray        # (n_cr,) uses per CR value
    n_accept: jnp.ndarray    # scalar int32
    t: jnp.ndarray           # generation counter


class _GenRand(NamedTuple):
    """Pre-drawn per-generation randomness (leading axis = generation)."""
    pairs: jnp.ndarray      # (n, 2*delta_max) int
    delta: jnp.ndarray      # (n,) int in [1, delta_max]
    u_cr: jnp.ndarray       # (n,) uniform for the CR inverse-CDF draw
    z: jnp.ndarray          # (n, d) uniform (subspace mask)
    force: jnp.ndarray      # (n,) int in [0, d)
    u_jump: jnp.ndarray     # (n,) uniform (unit-gamma mode jumps)
    e: jnp.ndarray          # (n, d) uniform in [-b, b]
    eps: jnp.ndarray        # (n, d) b_star * normal
    u_acc: jnp.ndarray      # (n,) uniform (metropolis accept)


def _draw_chunk(key, n_gens, n_chains, d, delta_max, b, b_star, dtype):
    """All randomness for ``n_gens`` generations in 9 batched draws.

    Per-op kernel-launch overhead inside a scan step made the ~25 PRNG
    ops of a draw-per-generation design the dominant cost at small chain
    counts; drawing a chunk at once amortizes them n_gens-fold.
    """
    ks = jax.random.split(key, 9)
    g = (n_gens,)
    return _GenRand(
        pairs=pick_others_batched(ks[0], n_chains, 2 * delta_max,
                                  n_batch=n_gens),
        delta=jax.random.randint(ks[1], g + (n_chains,), 1, delta_max + 1),
        u_cr=jax.random.uniform(ks[2], g + (n_chains,), dtype),
        z=jax.random.uniform(ks[3], g + (n_chains, d), dtype),
        force=jax.random.randint(ks[4], g + (n_chains,), 0, d),
        u_jump=jax.random.uniform(ks[5], g + (n_chains,), dtype),
        e=jax.random.uniform(ks[6], g + (n_chains, d), dtype, -b, b),
        eps=b_star * jax.random.normal(ks[7], g + (n_chains, d), dtype),
        u_acc=jax.random.uniform(ks[8], g + (n_chains,), dtype),
    )


def _cr_histogram(cr_ids, jds, n_cr, dtype):
    """Per-CR-bin (jump-distance sum, use count), scatter-free.

    One-hot masked reductions instead of ``.at[cr_ids].add``: the
    generation body holds no scatter, only elementwise ops and
    reductions. Shared by the single-chip and mesh-sharded generation
    bodies so the same-answer property can't drift.
    """
    onehot = (cr_ids[:, None] == jnp.arange(n_cr)[None, :]).astype(dtype)
    return jnp.sum(onehot * jds[:, None], axis=0), jnp.sum(onehot, axis=0)


def _dream_generation(state: DreamState, rand: _GenRand, ln_prob_fn,
                      delta_max, n_cr, gamma_jump_prob, n_adapt,
                      prop_fixup_fn):
    """One DREAM generation from pre-drawn randomness (see _draw_chunk)."""
    n_chains, d = state.heads.shape
    dtype = state.heads.dtype
    # chain spread for jump-distance normalization (guard zeros)
    chain_std = jnp.std(state.heads, axis=0) + 1e-30

    pair_mask = (
        jnp.arange(delta_max)[None, :] < rand.delta[:, None]
    ).astype(dtype)[..., None]                       # (n, dm, 1)
    a_idx = rand.pairs[:, :delta_max]
    b_idx = rand.pairs[:, delta_max:]
    diff = jnp.sum(
        (state.heads[a_idx] - state.heads[b_idx]) * pair_mask, axis=1
    )                                                 # (n, d)

    # crossover draw via inverse CDF of the (adapting) p_cr — identical in
    # distribution to jax.random.categorical but usable with pre-drawn
    # uniforms
    cdf = jnp.cumsum(state.p_cr)[:-1]
    cr_ids = jnp.sum(rand.u_cr[:, None] > cdf[None, :], axis=1)
    cr = (cr_ids.astype(dtype) + 1.0) / n_cr
    mask = rand.z < cr[:, None]
    # guarantee at least one updated dimension per chain. One-hot OR, not
    # .at[...].set, keeps the scan body free of scatters; the history is
    # bitwise identical either way.
    mask = mask | (jnp.arange(d)[None, :] == rand.force[:, None])
    d_eff = jnp.sum(mask.astype(dtype), axis=1)

    gamma = 2.38 / jnp.sqrt(2.0 * rand.delta.astype(dtype) * d_eff)
    unit_jump = rand.u_jump < gamma_jump_prob
    gamma = jnp.where(unit_jump, jnp.asarray(1.0, dtype), gamma)

    step = (1.0 + rand.e) * gamma[:, None] * diff + rand.eps
    prop = jnp.where(mask, state.heads + step, state.heads)
    if prop_fixup_fn is not None:
        prop = jax.vmap(prop_fixup_fn)(prop)

    lnp_prop = jax.vmap(ln_prob_fn)(prop)
    alpha = jnp.exp(jnp.minimum(lnp_prop - state.head_lnp, 0.0))
    alpha = jnp.where(jnp.isnan(alpha), 0.0, alpha)
    accepts = rand.u_acc < alpha
    xs = jnp.where(accepts[:, None], prop, state.heads)
    lnps = jnp.where(accepts, lnp_prop, state.head_lnp)
    # squared normalized jump distance of the realized moves
    jds = jnp.sum(((xs - state.heads) / chain_std) ** 2, axis=1)

    # crossover adaptation (burn-in only)
    jd_add, id_add = _cr_histogram(cr_ids, jds, n_cr, dtype)
    jump_dist = state.jump_dist + jd_add
    n_id = state.n_id + id_add
    mean_jump = jump_dist / jnp.maximum(n_id, 1.0)
    p_cr_new = mean_jump / jnp.maximum(jnp.sum(mean_jump), 1e-30)
    p_cr_new = jnp.maximum(p_cr_new, 0.05 / n_cr)  # keep every CR alive
    p_cr_new = p_cr_new / jnp.sum(p_cr_new)
    adapting = state.t < n_adapt
    p_cr = jnp.where(adapting, p_cr_new, state.p_cr)

    return DreamState(
        xs, lnps, state.key, p_cr, jump_dist, n_id,
        state.n_accept + jnp.sum(accepts, dtype=jnp.int32),
        state.t + 1,
    )


def make_dream_state(init_heads, ln_prob_fn: Callable, n_cr: int = _CFG.n_cr,
                     key=0) -> DreamState:
    """Fresh DREAM state: uniform CR probabilities, zeroed adaptation
    statistics, generation counter at 0."""
    import numpy as _np

    from corrla_rs_tpu.utils.smallpath import route_sampler_small

    (init_heads,) = route_sampler_small(
        init_heads, n_chains=int(_np.shape(init_heads)[0])
    )
    heads = jnp.asarray(init_heads)
    # eager vmap (one batched dispatch) — wrapping in a fresh jax.jit here
    # would create a new cache entry per call and silently recompile the
    # user's ln_prob_fn on every dream_run invocation
    lnp0 = jax.vmap(ln_prob_fn)(heads)
    return DreamState(
        heads, lnp0, as_key(key),
        jnp.ones((n_cr,), heads.dtype) / n_cr,
        jnp.zeros((n_cr,), heads.dtype),
        jnp.zeros((n_cr,), heads.dtype),
        jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.int32),
    )


def _chunk_for(n_chains: int) -> int:
    """Generations per pre-drawn randomness chunk (DEMC + small-DREAM).

    DREAM itself schedules via ``_sched_for`` below;
    ``ops.samplers.demc_run`` still imports this.

    Small populations are dominated by per-generation kernel-launch
    overhead -> amortize with big chunks. Large populations move the
    chunk tensors ((chunk, n, d) x 6) through device memory -> keep
    chunks small. The values were tuned on an earlier accelerator and
    are untuned on the H100; results do not depend on them.
    """
    return max(5, min(50, 25600 // max(n_chains, 1)))


def _sched_for(n_chains: int) -> tuple[int, int]:
    """(chunk, unroll) schedule for the scatter-free generation body.

    Mid-size populations are scan-overhead-bound (chunk 10 / unroll 8);
    very large ones pay memory traffic for the (chunk, n, d) randomness
    tensors and take the smallest chunk; small ones amortize the PRNG
    draws with big chunks and a shallow unroll. The table was tuned on an
    earlier accelerator and is untuned on the H100. Histories are bitwise
    identical across schedules, so only speed depends on it.
    """
    if n_chains <= 2048:
        return _chunk_for(n_chains), 4
    if n_chains <= 16384:
        return 10, 8
    return 5, 4


@functools.partial(
    jax.jit,
    static_argnames=(
        "ln_prob_fn", "n_chunks", "chunk", "delta_max", "n_cr",
        "prop_fixup_fn", "n_adapt", "unroll",
    ),
)
def _dream_scan(state: DreamState, ln_prob_fn, n_chunks, chunk, delta_max,
                n_cr, gamma_jump_prob, b, b_star, n_adapt, prop_fixup_fn,
                unroll):
    """n_chunks x chunk generations; randomness pre-drawn per chunk."""
    n_chains, d = state.heads.shape
    dtype = state.heads.dtype

    def inner(st, rand):
        st = _dream_generation(
            st, rand, ln_prob_fn, delta_max, n_cr, gamma_jump_prob,
            n_adapt, prop_fixup_fn,
        )
        return st, st.heads

    def outer(state, _):
        key, k_draw = jax.random.split(state.key)
        rand = _draw_chunk(
            k_draw, chunk, n_chains, d, delta_max, b, b_star, dtype
        )
        state, hist = lax.scan(
            inner, state._replace(key=key), rand,
            unroll=min(unroll, max(chunk, 1)),
        )
        return state, hist

    state, hist = lax.scan(outer, state, None, length=n_chunks)
    return state, hist.reshape(n_chunks * chunk, n_chains, d)


def dream_run(init_heads, ln_prob_fn: Callable, n_steps: int, key=0,
              delta_max: int = _CFG.delta_max, n_cr: int = _CFG.n_cr,
              gamma_jump_prob: float = _CFG.gamma_jump_prob,
              b: float = _CFG.b, b_star: float = _CFG.b_star,
              n_adapt: int = _CFG.n_adapt, prop_fixup_fn=None,
              unroll: int | None = None,
              init_state: DreamState | None = None):
    """Run n_steps DREAM generations; returns (history, final_state).

    history: (n_steps, n_chains, d). ``n_adapt``: generations of crossover
    adaptation (0 = fixed uniform CR probabilities; for a valid stationary
    chain discard at least the first n_adapt generations).

    ``init_state``: resume from a previous run's final ``DreamState`` —
    heads, adapted CR probabilities, jump statistics, and the generation
    counter all carry over (``init_heads`` is ignored); the PRNG stream is
    re-seeded from ``key``. This is how DreamSampler threads adaptation
    across blocks instead of restarting it.
    """
    if init_state is None:
        state = make_dream_state(init_heads, ln_prob_fn, n_cr=n_cr, key=key)
    else:
        state = init_state._replace(key=as_key(key))
    n_chains = state.heads.shape[0]
    assert n_chains >= 2 * delta_max + 1, (
        "DREAM needs n_chains >= 2*delta_max + 1"
    )
    n_steps = int(n_steps)
    chunk_size, auto_unroll = _sched_for(n_chains)
    if unroll is None:
        unroll = auto_unroll
    run = functools.partial(
        _dream_scan, ln_prob_fn=ln_prob_fn, delta_max=delta_max, n_cr=n_cr,
        gamma_jump_prob=gamma_jump_prob, b=b, b_star=b_star, n_adapt=n_adapt,
        prop_fixup_fn=prop_fixup_fn, unroll=unroll,
    )
    histories = []
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


def outlier_reset(heads, head_lnp):
    """Vrugt-style outlier-chain correction (burn-in only).

    Chains whose head log-density falls below Q1 - 2*IQR are relocated to
    the best chain's state. Breaks detailed balance, so apply only during
    burn-in (DreamSampler does this automatically within its n_adapt
    window). Returns (new_heads, new_lnp, n_reset).
    """
    q1, q3 = jnp.percentile(head_lnp, jnp.asarray([25.0, 75.0]))
    thresh = q1 - 2.0 * (q3 - q1)
    is_outlier = head_lnp < thresh
    best = jnp.argmax(head_lnp)
    new_heads = jnp.where(is_outlier[:, None], heads[best][None, :], heads)
    new_lnp = jnp.where(is_outlier, head_lnp[best], head_lnp)
    return new_heads, new_lnp, jnp.sum(is_outlier)


class DreamSampler:
    """Stateful wrapper mirroring the DeMcSampler surface (get_samples,
    accept_ratio) with DREAM proposals.

    ``outlier_correct=True`` applies the IQR outlier-chain test every
    ``outlier_every`` generations while still inside the ``n_adapt``
    burn-in window (stuck chains relocate to the best chain — standard
    DREAM practice; never applied after burn-in, so the stationary chain
    remains a valid MCMC)."""

    def __init__(self, ln_prob_fn: Callable, init_chains,
                 delta_max: int = _CFG.delta_max, n_cr: int = _CFG.n_cr,
                 gamma_jump_prob: float = _CFG.gamma_jump_prob,
                 b: float = _CFG.b, b_star: float = _CFG.b_star,
                 n_adapt: int = _CFG.n_adapt,
                 prop_fixup_fn: Callable | None = None, key=0,
                 outlier_correct: bool = False, outlier_every: int = 100,
                 config: DreamConfig | None = None):
        heads = jnp.asarray(init_chains)
        self.n_chains, self.ndim = heads.shape
        self.ln_prob_fn = ln_prob_fn
        cfg = config or DreamConfig(
            delta_max=delta_max, n_cr=n_cr, gamma_jump_prob=gamma_jump_prob,
            b=b, b_star=b_star, n_adapt=n_adapt,
        )
        self.cfg = dict(
            delta_max=cfg.delta_max, n_cr=cfg.n_cr,
            gamma_jump_prob=cfg.gamma_jump_prob, b=cfg.b, b_star=cfg.b_star,
            n_adapt=cfg.n_adapt,
        )
        self.prop_fixup_fn = prop_fixup_fn
        self.outlier_correct = bool(outlier_correct)
        self.outlier_every = int(outlier_every)
        self._key = as_key(key)
        self._heads = heads
        # full DreamState threads across blocks: the adapted p_cr, jump
        # statistics and the generation counter persist, so adaptation
        # continues across _run_block calls and FREEZES (rather than
        # resetting to uniform) once state.t reaches n_adapt
        self._state: DreamState | None = None
        self._history = [heads[None, :, :]]
        self.n_accept = 0
        self.n_total = 0
        self.n_outlier_resets = 0
        self._gens = 0  # generations drawn so far (adaptation is global)

    def _run_block(self, block: int):
        self._key, run_key = jax.random.split(self._key)
        prev_accepts = int(self._state.n_accept) if self._state is not None else 0
        history, state = dream_run(
            self._heads, self.ln_prob_fn, block, key=run_key,
            prop_fixup_fn=self.prop_fixup_fn, init_state=self._state,
            **self.cfg,
        )
        self._state = state
        self._heads = state.heads
        self._history.append(history)
        self.n_accept += int(state.n_accept) - prev_accepts
        self.n_total += block * self.n_chains
        self._gens += block

    def sample_mcmc(self, n_samples: int):
        n = int(n_samples)
        done = 0
        while done < n:
            adapt_left = max(self.cfg["n_adapt"] - self._gens, 0)
            if self.outlier_correct and adapt_left > 0:
                block = min(self.outlier_every, n - done, adapt_left)
            else:
                block = n - done
            self._run_block(block)
            done += block
            if self.outlier_correct and self._gens <= self.cfg["n_adapt"]:
                new_heads, new_lnp, n_reset = outlier_reset(
                    self._state.heads, self._state.head_lnp
                )
                self._state = self._state._replace(
                    heads=new_heads, head_lnp=new_lnp
                )
                self._heads = new_heads
                self.n_outlier_resets += int(n_reset)
        return self

    def accept_ratio(self) -> float:
        return self.n_accept / self.n_total if self.n_total else 0.0

    @property
    def chain_history(self) -> jnp.ndarray:
        return jnp.concatenate(self._history, axis=0)

    def get_chain_samples(self, n_tail: int, chain_id: int) -> jnp.ndarray:
        return self.chain_history[-n_tail:, chain_id, :]

    def get_samples(self, n_tail: int) -> jnp.ndarray:
        if n_tail == 0:
            return jnp.zeros((0, self.ndim), self.chain_history.dtype)
        tail = self.chain_history[-n_tail:]
        return tail.reshape(n_tail * self.n_chains, self.ndim)
